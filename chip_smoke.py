#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (src/repro_torch) on one card.

    python3 chip_smoke.py

Drives the port's ported paths at the full width of the NYTimes
configuration (V = 101,636, K = 1024, alpha = 50/K, beta = 0.01) and holds
every CUDA kernel of those paths against its plain PyTorch version on the
card.  Phases, one JSON line each:

1. the card (``nvidia-smi`` name and power limit, torch's device name);
2. the build of every kernel from ``src/repro_torch/kernels/*/csrc`` with
   nvcc, one process per source, all started together, timed;

Serving (a planted model made from a seed; engine buckets B <= 32,
L in {32, 64, 128, 256}; 8 burn-in + 4 sample sweeps):

3. fold-in kernel (K3) against plain version at each L bucket, P = min(L,
   K), on the 256 served documents in batches of B = 32 (the launch shape
   the engine gives each bucket, printed beside its result), rows gathered
   from the planted model, same z0 and uniforms;
4. K3 and plain-version times at each L bucket, B = 32 (``time_ms``: CUDA
   events around 20 launches run back to back after 3 warm-up launches);
5. the serving main path: ``LDAServeEngine`` serves unseen documents drawn
   from the model (one cold burst), the same documents again in
   ``WARM_BURSTS`` warm bursts (each burst's p99 and docs/s, their median
   and spread: one cold burst's p99 spreads too widely to resolve a
   change), then hot-swaps a second planted model and serves more; K3's
   launch counter is read around it;
6. the same storm warm and traced: the host span breakdown;
16. V-sharded serving at the same width (run here, while the planted
    snapshots are live; numbered after the training phases it follows in
    the port's history): the planted model split into ``SHARDS`` word
    blocks, one a card when there are that many cards, else all on cuda:0
    (``placement``); one B = 32, L = 256 batch of the served docs through
    ``fold_in_sharded`` under psum and all2all against the dense
    ``fold_in`` on the same drawn (z0, uniforms), both through K3; each
    comm's device time (``time_ms``) and wall time a call (host routing
    plan + launches + synchronise) beside the dense call's; an engine per
    comm on the sharded snapshot (a cold and ``WARM_BURSTS`` warm bursts of
    the 256 docs, p99 and docs/s beside phase 5's), the all2all one then
    hot-swapped sharded -> dense -> sharded (the second planted model); a
    ``.sharded`` directory of the planted model written, read back and
    assembled, and read once more with one byte flipped.  K3's counter is
    read around the engines' runs and added to the kernels line.

Training (``configs/lda_nytimes.CONFIG`` on ``nytimes_like(1.0)``:
D = 299,752 docs, V = 101,636, ~99.5M tokens, Zipf 1.1):

7. host preparation: corpus, tiling, move to the card, K2's and K4's
   segment table and K4's list of rows to zero (built once per tiling);
   the ELL's element type (int16 where K and the longest document allow,
   C7);
8. the sweep kernel (K1) against its plain version: one sweep from the
   initial state and the same uniforms on the heaviest word's first 1024
   tiles and the last 1024 (tail) tiles, at full K and V, on the ELL the
   trainer builds (``trainer.theta_and_ell``); that ELL, the ELL kernel's
   output, against its plain version on the same theta (``ell_vs_plain``);
9. the count kernels (K2 phi delta, K4 phi rebuild) against their plain
   versions at full V x K, after one full-width K1 sweep, K4 also into
   memory the allocator has just freed from a tensor of -1 (a row K4
   neither writes whole nor zeroes shows there);
10. K1, K2, K4 and the ELL kernel times at full width (``time_ms``, 20
    launches; the plain K1 3, the plain ELL 5), each with its bound and,
    for K2 and K4, one
    ``index_add_`` as the library yardstick; K1 also with the bytes its
    design moves (``k1_design``: runs, mean run length, design bytes and
    the rate they were moved at);
11. the training main path: ``fit(corpus, CONFIG, 10)`` on cuda:0 with
    eval every iteration, then K4 rebuilds phi from the final z; the K1,
    K2, K4 and ELL counters are read around both; the trained theta's ELL
    against its plain version again, and the kernel timed on it
    (``train_ell_timing``); then one more iteration
    between a reset and a read of the card's peak (``train_step_memory``,
    not counted: the dry run's ``--lda-card-run`` reckons its peak);
12. K1 against its plain version again, on the trained state (the same
    tiles as in 8);
13. where an iteration's time goes: each step of ``lda_iteration`` timed
    alone on the final state (``time_ms``, 5 calls), with K1's design
    bytes on that state;
14. ``torch.profiler`` over two steady ``lda_iteration`` calls on the final
    state: the device-busy share of the window and the ten kernels with the
    most device time (or ``device_time_visible: false`` when the trace
    holds no device time);

Training over a process group (one NCCL rank met through a ``file://``
store, a ("data",) ``DeviceMesh``; the group is destroyed at the end):

15. whether NCCL takes int16 (fault F4); one ``DistributedLDA.step`` on the
    phase-7 tiling against ``lda_iteration`` from phase 11's final state
    with the uniforms the single-device path draws there; that iteration's
    delta synced by the int32 all-reduce and by the int16 byte wire, each
    timed (``time_ms``), beside the bytes each wire sends per rank at
    G = 1 and G = 4; ``fit(corpus, CONFIG, 5, mesh)`` with
    ``compressed_sync`` off and on, each followed by K4 on its final z (the
    K1, K2 and K4 counters read around both and added to the kernels
    line), median tokens/s beside phase 11's; the 2d path on a (1, 1) mesh
    on ``nytimes_like(0.1)``, compressed, 3 iterations.

PubMed (``configs/lda_pubmed.CONFIG`` on ``lda_pubmed.scaled(PUBMED_SCALE)``
at full width, V = 141,043, K = 1024; the depth is cut to what one card
holds, see PERF.md):

17. host preparation (corpus, tiling, tables; seconds each, P and the ELL
    type); K1 against its plain version on the heaviest and tail tiles,
    K2 and K4 against theirs at full V x K; ``fit(corpus, CONFIG, 5)``
    with eval every iteration, then K4 on its final z, the K1, K2 and K4
    counters read around both; K1 against plain again on the trained state
    and each step of an iteration timed alone (with the ``theta_to_ell``
    share); the phase's peak device memory (``peak_bytes``, reset at its
    start);

The examples on the card:

18. ``examples/torch_quickstart.py`` and ``examples/torch_serve_lda.py``
    through their ``main`` at their default sizes on cuda:0, the four
    kernels' counters read around them.

The LM zoo's serving path (``repro_torch.models``; no kernel of the
port's own: its products are torch einsums, as the reference's are XLA
einsums):

19. every architecture of ``configs/archs.py`` at its ``smoke()`` width in
    float32 (TF32 off), weights and a stand-in state of 8 tokens drawn on
    the CPU from a seed: a prefill of 16 tokens and 4 decode steps (max_len
    32, so a window-8 ring wraps) on cuda:0 and on the CPU; but for the two
    MoE archs, a 16-token prompt decoded token by token on the card against
    its prefill (whisper against its encoder's keys and values);
20. qwen3-4b at full width (36 layers, d_model 2560, 32 query and 8 KV
    heads of 128, d_ff 9728, vocabulary 151,936 padded to 153,600; 4.03B
    parameters, 8.05 GB in bf16), weights drawn on the card from a seed:
    (a) the same weights in float32, a 64-token prompt's prefill against
    its decode token by token; (b) bf16 against that float32 model, 8
    teacher-forced decode steps (max error relative to scale, top-1
    agreement); (c) serving: stand-in caches of 1024 tokens (max_len
    2048) at batch 8 and 32, 64 greedy bf16 decode steps each (tokens/s,
    ms a step, the step's bytes bound: weights plus every cache slot read,
    over 3.35 TB/s), then ``torch.profiler`` over 4 steps (device-busy
    share); (d) a prefill of 4096 tokens at batch 1 (the chunked causal
    path) against its FLOP bound at 989 TFLOP/s (dense bf16); the phase's
    ``peak_bytes``; everything freed after;
21. ``repro_torch.launch.serve.main`` at the reference's defaults (smoke
    width, batch 8, 16 steps) on cuda:0 for qwen3-4b and mamba2-130m.

The LM zoo's training path (``zoo.make_train_step`` -> ``loss_fn`` with
autograd, blocks and CE chunks recomputed in the backward ->
``optim/adamw.py``; no kernel of the port's own):

22. every architecture at its ``smoke()`` width in float32 (TF32 off),
    weights and a B = 2, S = 16 batch drawn on the CPU from a seed: two
    ``train_step``s on cuda:0 and on the CPU from the same state and batch
    (loss, grad norm and every tensor of the state compared after each);
    then in bf16 two steps on the card on one batch;
23. qwen3-4b training at full width, weights drawn on the card from a seed
    (bf16 params, float32 AdamW master, m and v): batches of
    ``data.loader.lm_batches(vocab, 1, 4096)`` through ``PrefetchLoader``
    on cuda:0 (4 CE chunks; the chunked causal attention); 2 warm-up steps,
    8 steps between CUDA events (ms a step, tokens/s, model FLOPs against
    989 TFLOP/s: ``mfu``), 2 steps split into forward + backward and
    optimizer (CUDA events), the last batch trained once more, one step
    under ``torch.profiler`` (busy share, top kernels, the optimizer's
    share); the state's bytes against the 64.4 GB reckoned, ``peak_bytes``;
    everything freed after;
24. ``repro_torch.launch.train.main(["--workload", "lm", ...])`` for 20
    steps on cuda:0 (smoke width, B = 8, S = 128) for qwen3-4b and
    mamba2-130m, ``examples/torch_train_lm.py`` for 60 steps and
    ``examples/torch_serve_lm.py`` at its defaults on cuda:0.

The LM zoo's training over a ("data", "model") mesh (``ShardingPolicy``
from ``launch/specs.make_policy``, tensor parallelism and ZeRO-3 through
``models/parallel.py``; no kernel of the port's own):

25. one NCCL rank met through a ``file://`` store, a (1, 1) mesh: every
    architecture at its ``smoke()`` width in float32 (TF32 off; the MoE
    archs through their expert-parallel path, ``moe.moe_ffn_ep``), two
    mesh ``train_step``s (state sharded, gathered back after each)
    against two one-device steps on the card from the same weights and
    batch; then qwen3-4b at full width (bf16 params, float32 AdamW),
    B = 1, S = 4096 on ``lm_batches`` (phase 23's stream), 4 mesh steps:
    ms a step (CUDA events over the last 3), tokens/s, ``mfu``, peak
    bytes, the losses beside phase 23's first four; then the same for
    qwen3-moe-30b-a3b at its published widths cut to MOE_LAYERS_ONE
    layers (``mfu`` of the reference's count, active parameters), with the
    share of (token, k) routings its capacity dropped in the first step
    and one more step under ``torch.profiler`` (busy share, top kernels).
    ``python3 kernel_probe.py --lm-moe-four`` runs the MoE on four cards.
    With four cards or
    more (``lm_mesh_four``; ``python3 kernel_probe.py --lm-mesh-four``
    runs phases 23 and 25 alone, then a planted fault), 4 spawned NCCL
    ranks train qwen3-4b at full width on a (1, 4) mesh
    (``launch/mesh.make_production_mesh(4)``) at B = 1 and B = 4 and a
    (2, 2) mesh (the launcher's ``training_mesh``) at B = 2: per
    configuration ms a step, tokens/s,
    ``mfu`` over 4 x 989 TFLOP/s, each card's peak bytes beside 64.4 GB /
    4, the losses, and one profiled step's busy share and NCCL time.
26. the LM zoo's serving over a mesh, one NCCL rank, a (1, 1) mesh
    (``make_production_mesh(1)``): qwen3-4b at full width, its params drawn
    one layer at a time under the decode policy (``init_params(policy=)``)
    against the whole draw; phase 20's decode (B in QWEN_BATCHES,
    QWEN_MAX slots holding QWEN_PREFILL tokens, a stand-in state drawn
    under the policy against the whole one) through
    ``make_decode_step(cfg, policy)`` for MESH_SERVE_STEPS steps, and its
    QWEN_S-token prefill through ``make_prefill_step(cfg, policy)``, each
    against the one-device step on the same inputs; ms a step of both.
    With four cards or more (``lm_serve_four``; ``python3 kernel_probe.py
    --lm-serve-four`` runs it alone), two spawns of 4 NCCL ranks: qwen3-4b
    on (1, 4) (decode_32k's 32,768-slot cache at B = 32, 64 steps, then
    prefill_32k's length at B = 1) and gemma2-27b's long_500k at its own
    size on (2, 2) (B = 1, 524,288 slots over "data", 32 steps), each
    first gated against one card (``serve_gate_reference``: the whole
    model on cuda:0 in this process) with its planted fault; per rank ms
    a step, tokens/s, the bytes bound, the peak, one profiled step's busy
    share and NCCL time, and the collective bytes a step.

A recurrent arch at full width (no kernel of the port's own):

27. mamba2-130m at its published widths on one card, weights drawn on the
    card from a seed (bf16 params, float32 AdamW): ``lm_train_timed`` at
    B = 8, S = 4096 on ``lm_batches`` (2 warm-up steps, 8 between CUDA
    events: ms a step, tokens/s, ``mfu`` of the reference's count, peak
    bytes, the losses); the weights drawn again, cast to float32 (TF32
    off), a 64-token prompt decoded token by token against its prefill;
    a 4,096-token bf16 prefill at B = 1 (3 calls timed); 64 greedy bf16
    decode steps at B = 32 from a stand-in state (ms a step beside the
    bound of the weights read once and the state read and written).
    ``python3 kernel_probe.py --lm-ssd-four`` runs it, then the SSD over
    four cards.

Model FLOPs (``mfu``): phases 23 and 25 count ``qwen_train_flops``: 6 N T
over the 4,026,727,936 parameter tensors (norms included) plus the
attention's score and PV products as executed (every key of each query
chunk).  Phase 25 also gives ``mfu_reference_count``, the reference's
count (``launch/roofline.step_flops``: 4,026,531,840 parameters, no norm
weights, and the causal half of the attention).

Bounds (fault F2: the kernels' prefix sums are float32 adds in another
order than torch.cumsum's, so a draw on a float boundary may flip):

* K3, one sweep: draws differ on <= 1e-3 of real tokens; full run: the
  sparse-draw count and the argmax topic agree on >= 99% of documents, the
  mean per-document L1 distance of normalised theta is <= 0.02;
* K1, one sweep on the initial and on the trained state: draws differ on
  <= 1e-3 of real tokens, and the sparse share and the mean S/(S+Q) agree
  within 1e-3 absolute;
* K2 and K4: equal to their plain versions (integer counts, exact), K4
  also into memory last filled with -1, and phi_old + K2 == K4(z_new);
* the ELL kernel, on the initial and the trained theta (and PubMed's
  initial one): equal to its plain version bit for bit (counts, topics
  with their padding, the overflow flag);
* serving: every theta sums to 1 (atol 1e-4), the planted major topic is
  recovered on >= 90% of documents in every burst, every answer after the
  swap carries the new model version, and K3 was launched;
* sharded serving: theta, top_topics, sparse_frac and mean_s_over_sq equal
  the dense fold-in's bit for bit under both comms; >= 90% recovery in
  every burst and after each swap, the version bumped by every swap; the
  engine's ``comm_bytes_moved`` equal to the sum of the bytes of the plans
  it made, one H2D copy a batch; K3 launched; the reloaded directory's phi
  equal to the model's, and the flipped byte refused
  (``SnapshotIntegrityError``);
* training: K1 and K2 launched once per iteration plus once for fit's
  warm-up iteration, the ELL kernel at least as often, the last LL/token
  above the first, phi == K4(z)
  exactly, phi_sum == phi.sum(0), phi.sum() == number of tokens, every z
  in [0, K);
* PubMed: as training (K1's flips <= 1e-3, K2 and K4 exact, K1 and K2
  launched once per iteration plus the warm-up, LL/token rising, phi ==
  K4(z), the sums), V = 141,043 and K = 1024;
* examples: both finish; the quickstart's LL/token rises through K1 and
  K2, the serving example launches K3 and swaps to version 3;
* over the group: the mesh step equal to ``lda_iteration`` (z, phi,
  phi_sum), the byte wire returning the delta exactly, both wires training
  the same state, phi == K4(z) after each full-width run, and in every
  mesh run K1 and K2 launched once per iteration plus the warm-up, the
  LL/token rising, phi_sum == phi.sum(0), phi.sum() == number of tokens;
* the LM zoo: every smoke arch's logits on the card within 1e-4 of the
  CPU's (of the logits' scale), decode == prefill within 1e-4 relative,
  finite, the position advanced; qwen3-4b: 4,026,727,936 parameters, the
  float32 decode == prefill within 1e-3 of scale, bf16 within 0.1 of
  scale of float32, finite logits and the position advanced at every
  batch; the launcher runs on cuda:0 with finite logits;
* LM training: every smoke arch's two float32 steps on the card within
  1e-5 of the CPU's loss (relative), 1e-4 of its grad norm, and every
  param, master, m and v within 2 lr_t + 1e-6 (summed over the steps; an
  AdamW first step is g / (|g| + eps), so a float difference of a
  gradient entry near 0 moves it by up to lr_t), step exact; bf16 finite
  with the second loss below the first + 0.05; qwen3-4b: 4,026,727,936
  parameters, every step's loss and grad norm finite, the last batch
  trained again to a loss no more than 0.05 above; the launcher's losses
  finite on cuda, the example's loss falling, the serving example on cuda
  with finite logits;
* LM training over a mesh: every smoke arch's two mesh steps within the
  same bounds of the one-device steps on the card; qwen3-4b's mesh losses
  finite and within 1e-5 relative of phase 23's first four (the (1, 1)
  mesh runs phase 23's arithmetic); the MoE's losses and grad norms
  finite; on four cards every configuration's
  losses finite, and the (1, 4) mesh's B = 1 losses within 1e-3 relative
  of the (1, 1) mesh's (the same batches; bf16 sums in another order
  differ by 1.8e-4, a dropped tp all-reduce by more than the bound: see
  PERF.md);
* LM serving over a mesh: on the (1, 1) mesh the params and the stand-in
  state drawn under the policy equal the whole draws, and every decode
  step's logits and the prefill's equal the one-device step's bit for bit
  (an axis of size one runs no collective), the position advanced; on
  four cards every rank's logits finite, the collective bytes of a decode
  step activation-sized (below SERVE_ACT_SHARE of the card's weight bytes:
  no weight is all-gathered), and each gate's four-card logits within
  SERVE_GATE_REL of the one card's (of their scale, over every step), its
  planted fault beyond it (qwen3-4b on (1, 4), layout (a): one tp rank's
  attention output left out of ``wo``'s all-reduce; gemma2-27b on (2, 2),
  layout (c): one slot shard's partial sums left out of the softmax's
  combine);
* mamba2-130m: every loss and grad norm finite, the least of the last
  three losses below the first, the float32 decode == prefill within
  1e-3 of scale, the bf16 decode's logits finite and the position
  advanced.

Fails (non-zero exit, no result line) without a CUDA card, outside a
checkout of the repository, or when any phase fails.
"""
from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

ONE_SWEEP_MISMATCH = 1e-3
DOC_AGREEMENT = 0.99
MEAN_THETA_L1 = 0.02
RECOVERY = 0.90
SUM_ATOL = 1e-4

from repro_torch.launch.mesh import (  # noqa: E402  (H100 SXM data sheet)
    HBM_BW as HBM_BYTES_PER_S, PEAK_FLOPS_BF16 as BF16_FLOPS,
    PEAK_FLOPS_F32 as FP32_FLOPS)

INT32_OPS = FP32_FLOPS / 2     # Hopper SM: 64 INT32 lanes to 128 FP32 lanes

KERNELS = ("fold_in", "lda_sample", "phi_update", "ell_select")
TRAIN_FLIP_RATE = 1e-3
TRAIN_STAT_ATOL = 1e-3
CMP_TILES = 1024               # heaviest-word tiles and tail tiles each
TRAIN_SCALE = 1.0              # nytimes_like scale: the full NYTimes size
TRAIN_ITERS = 10
MESH_ITERS = 5                 # fit(mesh=...) at full width, each wire
MESH_2D_SCALE = 0.1            # the 2d (1 x 1) run's corpus
MESH_2D_ITERS = 3
PUBMED_SCALE = 0.75            # lda_pubmed.scaled: the depth one card holds
PUBMED_ITERS = 5
SEED = 0

# the LM zoo (phases 19-21)
LM_B, LM_S, LM_PREFILL, LM_STEPS, LM_MAX = 2, 16, 8, 4, 32
LM_ARCH_REL = 1e-4             # card vs CPU, decode vs prefill (float32)
QWEN_PARAMS = 4_026_727_936    # qwen3-4b's tensors (norms included),
                               # vocabulary padded to 153,600; the
                               # reference's param_counts: 4,026,531,840
QWEN_PROMPT = 64
QWEN_F32_REL = 1e-3            # float32 decode vs prefill, of the scale
QWEN_BF16_STEPS = 8
QWEN_BF16_REL = 0.1            # bf16 vs float32 of the same weights
QWEN_BATCHES, QWEN_STEPS, QWEN_PROFILED = (8, 32), 64, 4
QWEN_PREFILL, QWEN_MAX = 1024, 2048
QWEN_S, QWEN_PREFILL_CALLS = 4096, 3

# the LM zoo's training path (phases 22-24)
LM_TRAIN_B, LM_TRAIN_S, LM_TRAIN_STEPS = 2, 16, 2
LM_LOSS_REL, LM_NORM_REL, LM_STATE_ATOL = 1e-5, 1e-4, 1e-6
LM_TWO_STEP_RISE = 0.05        # the reference's own two-step check
QWEN_TRAIN_B, QWEN_TRAIN_S = 1, 4096
QWEN_TRAIN_WARM, QWEN_TRAIN_TIMED, QWEN_TRAIN_SPLIT = 2, 8, 2
QWEN_STATE_RECKONED = 64.4e9   # bf16 params and grads, float32 master, m, v
LM_EXAMPLE_STEPS = 60

# the LM zoo over a mesh (phase 25)
MESH_LM_STEPS = 4              # the first warms up, the other 3 are timed
# (layout, B): "production" is make_production_mesh(4), (1, 4); "launcher"
# is the launcher's training_mesh, (2, 2)
MESH_LM_FOUR = (("production", 1), ("production", 4), ("launcher", 2))
MESH_FOUR_LOSS_REL = 1e-3      # (1, 4) at B = 1 against one card's losses
MESH_COLLECTIVE_TIMEOUT_S = 180  # a rank stuck this long fails the phase
MOE_ARCH = "qwen3-moe-30b-a3b"   # at its published widths, depth cut:
MOE_LAYERS_ONE = 6               # 4.05B parameters, 64.9 GB of state
MOE_LAYERS_FOUR = 16             # 10.28B parameters, 41.1 GB a card of 4
STATE_BYTES_PER_PARAM = 16       # bf16 params and grads, float32 master, m, v

# the LM zoo's serving over a mesh (phase 26)
MESH_SERVE_STEPS = 8           # (1, 1) decode steps at each QWEN_BATCHES
# four cards, (B, cache slots, decode steps): qwen3-4b on (1, 4) with
# decode_32k's cache, its batch cut from 128 to 32 (four cards cannot hold
# 618 GB of cache); prefill_32k's length at B = 1 (cut from 32);
# gemma2-27b's long_500k at its own size on (2, 2)
SERVE_FOUR_QWEN = (32, 32_768, 64)
SERVE_FOUR_PREFILL = (1, 32_768)
SERVE_FOUR_GEMMA = (1, 524_288, 32)
# the gates against one card: (B, slots, steps), bf16; the stand-in
# caches' keys scaled to unit variance (0.02 x 50), their values to a
# standard deviation of 64 (0.02 x 3200): unit-variance scores spread the
# softmax over ~1,500 of 4,096 slots, so unit values would average to
# ~0.03 and the attention (and any fault in its mesh code) would hardly
# reach the logits beside the MLPs
SERVE_GATE_QWEN = (8, 4_096, 8)
SERVE_GATE_GEMMA = (1, 8_192, 8)
SERVE_GATE_KV_SCALE = 50.0
SERVE_GATE_V_SCALE = 3200.0
SERVE_GATE_REL = 5e-2          # four cards against one, of the logits' scale
SERVE_ACT_SHARE = 0.1          # a decode step's collective bytes over the
                               # card's weight bytes (gathering each
                               # weight once would make it >= 1)
SERVE_TIMEOUT_S = 180          # a rank stuck this long fails the phase

# mamba2-130m at full width on one card (phase 27)
MAMBA_ARCH = "mamba2-130m"
MAMBA_TRAIN_B, MAMBA_TRAIN_S = 8, 4096
MAMBA_WARM, MAMBA_TIMED = 2, 8
MAMBA_PROMPT = 64              # float32 decode vs prefill, TF32 off
MAMBA_PREFILL_S, MAMBA_PREFILL_CALLS = 4096, 3
MAMBA_DECODE_B, MAMBA_DECODE_STEPS = 32, 64

BATCH, BUCKETS, SWEEPS = 32, (32, 64, 128, 256), (8, 4)
SERVE_DOCS, SWAP_DOCS = 256, 32
WARM_BURSTS = 7                # the cold burst's docs again, engine warm
SHARDS = 4                     # phase 16's phi blocks
COMMS = ("psum", "all2all")


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()
    return out[0]


def burst(engine, docs, majors) -> dict:
    """One burst of ``docs`` through a warm engine: its p50 / p99 latency,
    docs/s over its wall time, and the share of planted topics
    recovered."""
    import numpy as np

    t0 = time.perf_counter()
    results = engine.infer_many(docs, timeout=300.0)
    wall = time.perf_counter() - t0
    lat = np.asarray([r["latency_ms"] for r in results])
    if not np.allclose([r["theta"].sum() for r in results], 1.0,
                       atol=SUM_ATOL):
        raise AssertionError("a served theta does not sum to 1")
    return dict(p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                docs_per_sec=len(docs) / wall,
                recovered=float(np.mean([int(r["theta"].argmax()) == m
                                         for r, m in zip(results, majors)])))


def gathered_batch(snap, docs, L, seed, n_sweeps):
    """Docs -> the fold-in kernel's inputs at one bucket, on the card."""
    import torch

    from repro_torch.kernels.fold_in import ops
    from repro_torch.serve.infer import pack_docs

    dev = snap.device
    tokens, mask = pack_docs(docs, L)
    tok = torch.from_numpy(tokens).to(dev).long()
    m = torch.from_numpy(mask).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    z0, uni = ops.draw_fold_in_randoms(gen, len(docs), L, snap.num_topics,
                                       n_sweeps, dev)
    return (snap.phi_vk[tok].contiguous(), snap.phi_sum, snap.hyper,
            uni.transpose(0, 1).contiguous(), m.to(torch.int32), z0)


def bytes_and_ops(args, n_sweeps, z_final):
    """The least work of one launch: each input read once and each output
    written once; float operations of the p* precompute (4 per real token
    and topic) and of the sparse sums and searches, counted with each
    doc's final number of live topics standing in for every sweep's."""
    phi_tok, phi_sum, hyper, uni, mask, z0 = args
    B, L, K = phi_tok.shape
    nbytes = sum(t.numel() * t.element_size() for t in args)
    nbytes += B * K * 4 + B * 4 + B * 4 + B * L * 4          # outputs
    real = mask.sum(1)
    live = [len(set(z_final[b][mask[b] != 0].tolist())) for b in range(B)]
    ops = 4 * int(real.sum()) * K
    ops += sum(8 * int(real[b]) * live[b] for b in range(B)) * n_sweeps
    return nbytes, ops


def fold_in_vs_plain(snap, docs, L, V) -> dict:
    """K3 against its plain version at bucket L, on every batch of BATCH of
    ``docs`` (the engine's batches, so the kernel runs at the launch shape
    the serving path gives this bucket): the draws after one sweep from one
    start, and theta, the sparse share and the argmax topic after the full
    sweeps."""
    import torch

    from repro_torch.kernels.fold_in import kernel, ref

    K = snap.num_topics
    P = min(L, K)
    burn_in, samples = SWEEPS
    kw1 = dict(num_words_total=V, burn_in=0, samples=1, ell_capacity=P)
    kwf = dict(num_words_total=V, burn_in=burn_in, samples=samples,
               ell_capacity=P)
    flips = n_real = err = 0
    sp_eq, arg_eq, l1 = [], [], []
    ssq_rel, equal = 0.0, True
    for j, i in enumerate(range(0, len(docs), BATCH)):
        batch = docs[i:i + BATCH]
        one = gathered_batch(snap, batch, L, seed=11 + 2 * j, n_sweeps=1)
        k1 = kernel.fold_in_docs(*one, **kw1)
        r1 = ref.fold_in_docs_ref(*one, **kw1)
        real = one[4] != 0
        n_real += int(real.sum())
        flips += int(((k1[3] != r1[3]) & real).sum())
        full = gathered_batch(snap, batch, L, seed=12 + 2 * j,
                              n_sweeps=sum(SWEEPS))
        kf = kernel.fold_in_docs(*full, **kwf)
        rf = ref.fold_in_docs_ref(*full, **kwf)
        sp_eq.append(kf[1] == rf[1])
        arg_eq.append(kf[0].argmax(1) == rf[0].argmax(1))
        tk = kf[0].float() / kf[0].sum(1, keepdim=True).clamp(min=1)
        tr = rf[0].float() / rf[0].sum(1, keepdim=True).clamp(min=1)
        l1.append((tk - tr).abs().sum(1))
        err = max(err, int((kf[0] - rf[0]).abs().max()))
        ssq_rel = max(ssq_rel, float(((kf[2] - rf[2]).abs()
                                      / rf[2].abs().clamp(min=1e-30)).max()))
        equal = equal and bool(torch.equal(kf[0], rf[0]))
    return dict(B=BATCH, L=L, K=K, P=P, docs=len(docs),
                shape=kernel.launch_shape(BATCH, L, K, P),
                real_tokens=n_real, one_sweep_flips=flips,
                one_sweep_flip_rate=flips / n_real, theta_sum_equal=equal,
                sp_doc_agreement=float(torch.cat(sp_eq).float().mean()),
                argmax_doc_agreement=float(torch.cat(arg_eq).float().mean()),
                mean_theta_l1=float(torch.cat(l1).mean()),
                theta_sum_max_abs_err=err, ssq_max_rel_err=ssq_rel)


HOLD_CYCLES = 100_000_000      # ~57 ms of the card's clock: the host
#                                enqueues the timed calls meanwhile


def time_ms(fn, n=20, warm=3, hold=1):
    """Device time of one call of ``fn``: after ``warm`` calls, CUDA events
    around ``n`` calls run back to back, over n.  The stream is held by a
    spin kernel (``hold`` x ~57 ms) while the host enqueues them, so a
    kernel shorter than its Python launch path is timed on the card, not
    on the host (for a function that synchronises, the host's time stays
    in)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOLD_CYCLES * hold)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def slot_bytes(z) -> int:
    """K1's bytes per slot: token_doc, mask, z_old, the two uniforms read;
    z_new, the sparse flag and S/(S+Q) written."""
    return 4 + 1 + 2 * z.element_size() + 8 + 1 + 4


def run_starts(token_doc, mask):
    """(n, t) bool: the slots that start a run — a maximal stretch of a
    tile's real slots with one doc, whose tokens share S and the p1 prefix
    under delayed counts (K1 computes them once per run)."""
    first = mask.clone()
    first[:, 1:] &= ~(mask[:, :-1] & (token_doc[:, 1:] == token_doc[:, :-1]))
    return first


def search_steps(n):
    """Compares of a binary search for a count among n sorted prefixes."""
    import torch

    n = torch.as_tensor(n, dtype=torch.float64)
    return torch.ceil(torch.log2(n + 1))


def k1_bytes_and_ops(args, sparse, nb, bw):
    """The least work of one sweep (K1): each input read once, each output
    written once — of phi only the rows of the tiles' words, of the ELL only
    each present doc's live (non-zero) entries, counts and topics at the
    ELL's element size, and its live length; float operations: 4 per word
    and topic (p* and its prefix sums), 2 per live ELL entry once per run
    (S and the p1 prefix, shared by the run's tokens), and per real token
    2 for the side and a binary search's compares (over the live entries
    for a sparse draw, over nb block sums then bw in-block sums for a
    dense one)."""
    import torch

    (tile_word, token_doc, mask, z, phi, phi_sum, cnt, tpc, uni) = args
    n, t = z.shape
    K = phi.shape[1]
    live = (cnt > 0).sum(1)                                  # (D,)
    docs = torch.zeros_like(live, dtype=torch.bool)
    docs[token_doc[mask].long()] = True
    first = run_starts(token_doc, mask)
    run_live = live[token_doc[first].long()].to(torch.int64)
    tok_live = live[token_doc[mask].long()]
    sp = sparse[mask]
    words = int(torch.unique(tile_word).numel())
    nbytes = (n * 4 + n * t * slot_bytes(z) + words * K * 4 + K * 4
              + int(live[docs].sum()) * 2 * cnt.element_size()
              + int(docs.sum()) * 4)
    ops = (4 * K * words + 2 * int(run_live.sum()) + 2 * int(mask.sum())
           + int(search_steps(tok_live[sp]).sum())
           + int((~sp).sum()) * int(search_steps(nb) + search_steps(bw)))
    return nbytes, ops


def k1_design(args, ms, tiles_per_cta):
    """The bytes K1's design moves in one sweep, and the rate it moved them
    at in ``ms``: per run (``run_starts``) the doc's live ELL entries,
    counts and topics at the ELL's element size, and its live length; per
    slot what ``slot_bytes`` counts; per tile its word; a phi row (K int32)
    at each tile that starts a CTA's group of ``tiles_per_cta`` or changes
    the word within it.  Beside it the bytes of one warp per token reading
    its doc's row as int32 (8 B an entry) up to the 32-entry chunk that
    holds the row's first zero and a phi row per tile, the design this
    kernel replaced, by the same count."""
    import torch

    (tile_word, token_doc, mask, z, phi, phi_sum, cnt, tpc, uni) = args
    n, t = z.shape
    K, P = phi.shape[1], cnt.shape[1]
    live = (cnt > 0).sum(1).to(torch.int64)                  # (D,)
    first = run_starts(token_doc, mask)
    runs, real = int(first.sum()), int(mask.sum())
    run_live = int(live[token_doc[first].long()].sum())
    tok_live = live[token_doc[mask].long()]
    per_token = int(torch.clamp((tok_live // 32 + 1) * 32, max=P).sum())
    new_row = torch.ones_like(tile_word, dtype=torch.bool)
    new_row[1:] = tile_word[1:] != tile_word[:-1]
    new_row[::tiles_per_cta] = True
    phi_rows = int(new_row.sum())
    common = n * t * slot_bytes(z) + n * 4 + K * 4
    design = (run_live * 2 * cnt.element_size() + runs * 4 + common
              + phi_rows * K * 4)
    return dict(runs=runs, mean_run_tokens=real / max(runs, 1),
                mean_run_live=run_live / max(runs, 1),
                ell_dtype=str(cnt.dtype), phi_rows=phi_rows,
                design_bytes=design, design_gb_per_s=design / ms / 1e6,
                per_token_int32_bytes=per_token * 8 + common + n * K * 4)


def table_bytes(*tables) -> int:
    """The bytes of the tables a count kernel reads besides the tokens."""
    return sum(x.numel() * x.element_size() for x in tables)


def count_bytes_and_ops(n, t, z_bytes, V, K, real, delta: bool, tables):
    """K2 / K4: z (and z_old) and the mask read once, the segment table (and
    K4's list of rows to zero: ``tables`` bytes) read once, the (V, K)
    int32 output written once; one integer add per real token and z
    array."""
    nbytes = n * t * (z_bytes * (2 if delta else 1) + 1) + tables + V * K * 4
    return nbytes, real * (2 if delta else 1)


def bound(nbytes, ops, ops_rate):
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_rate * 1e3
    return dict(bytes=nbytes, ops=ops, bytes_ms=b_ms, ops_ms=o_ms,
                bound_ms=max(b_ms, o_ms),
                bound_by="bytes" if b_ms >= o_ms else "operations")


def ell_vs_plain(theta, P: int, dtype, state: str) -> int:
    """The ELL kernel (``updates.theta_to_ell`` on the card) against its
    plain version on the same (D, K) theta; returns the largest absolute
    difference over counts, topics and the overflow flag, and raises on
    any: the two are equal bit for bit, padding included."""
    import torch

    from repro_torch.core import updates
    from repro_torch.kernels.ell_select import ref as ell_ref

    got = updates.theta_to_ell(theta, P, dtype)
    want = ell_ref.theta_to_ell_ref(theta, P, dtype)
    err = max(int((g.int() - w.int()).abs().max()) for g, w in zip(got, want))
    emit("ell_vs_plain", state=state, docs=theta.shape[0], P=P,
         dtype=str(dtype), max_nnz=int((theta > 0).sum(1).max()),
         max_count=int(theta.max()),
         docs_over_127=int((theta.amax(1) > 127).sum()),
         overflowed=int(got[2].sum()), max_abs_err=err)
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"the ELL kernel differs from its plain version "
                             f"on the {state} theta: {err}")
    return err


def ell_bytes(theta, P: int, dtype) -> int:
    """The ELL kernel's least traffic: theta read once, counts and topics
    (D, P) and the (D,) flag written once."""
    D, K = theta.shape
    return D * K * 4 + D * min(P, K) * 2 * dtype.itemsize + D


def k1_vs_plain(full, kw, state: str) -> float:
    """One sweep of K1 and of its plain version from the same state and
    uniforms, on the heaviest word's first CMP_TILES tiles and the last
    CMP_TILES (tail) tiles; emits the comparison, raises past the bounds,
    and returns the largest S/(S+Q) error where the draws agree."""
    import torch

    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.lda_sample import ref as k1_ref

    n = full[0].shape[0]
    dev = full[0].device
    idx = (torch.arange(n, device=dev) if n <= 2 * CMP_TILES else
           torch.cat([torch.arange(CMP_TILES, device=dev),
                      torch.arange(n - CMP_TILES, n, device=dev)]))
    sl = tuple(a[idx].contiguous() if a.shape[0] == n else a for a in full)
    zk, spk, ssqk = k1_ops.launch_kernel(sl, **kw)
    zr, spr, ssqr = k1_ref.lda_sample_tiles_ref(*sl, **kw)
    torch.cuda.synchronize()
    m = sl[2]
    real = int(m.sum())
    flips = int(((zk != zr) & m).sum())
    same = (zk == zr) & m
    err = float((ssqk - ssqr)[same].abs().max())
    sp_diff = abs(float(spk[m].float().mean()) - float(spr[m].float().mean()))
    ssq_diff = abs(float(ssqk[m].mean()) - float(ssqr[m].mean()))
    emit("train_k1_vs_plain", state=state, tiles=int(idx.numel()),
         words=int(torch.unique(sl[0]).numel()), real_tokens=real,
         flips=flips, flip_rate=flips / real,
         sparse_share=float(spk[m].float().mean()),
         sparse_share_diff=sp_diff, mean_ssq=float(ssqk[m].mean()),
         mean_ssq_diff=ssq_diff, ssq_max_abs_err_where_equal=err)
    if flips / real > TRAIN_FLIP_RATE:
        raise AssertionError(f"K1 draws differ on {flips}/{real} tokens "
                             f"({state} state)")
    if sp_diff > TRAIN_STAT_ATOL or ssq_diff > TRAIN_STAT_ATOL:
        raise AssertionError(f"K1 sparse share / S-share differ by "
                             f"{sp_diff} / {ssq_diff} ({state} state)")
    return err


def profile_iterations(cfg, shard, state, iters: int) -> dict:
    """``torch.profiler`` (CPU and CUDA) over ``iters`` steady
    ``lda_iteration`` calls from ``state``, after one untraced warm-up.
    Returns the window's host wall time, the device-busy time (the union of
    the device events' intervals) and its share of the window, and the ten
    kernels with the most device time; ``device_time_visible`` is false
    when ``key_averages()`` holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import trainer

    trainer.lda_iteration(cfg, shard, state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = state
        for _ in range(iters):
            st, _ = trainer.lda_iteration(cfg, shard, st)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return device_busy(prof, wall_ms, iterations=iters)


def device_busy(prof, wall_ms: float, **fields) -> dict:
    """A ``torch.profiler`` window's device-busy time (the union of the
    device events' intervals), its share of the host's ``wall_ms`` and of
    the device span, and the ten kernels with the most device time;
    ``device_time_visible`` is false when ``key_averages()`` holds no
    device time."""
    from torch.autograd import DeviceType

    visible = sum(e.self_device_time_total for e in prof.key_averages()) > 0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not (visible and dev):
        return dict(fields, window_ms=wall_ms, device_time_visible=False)
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, end = 0.0, float("-inf")
    for a, b in spans:                      # union of the device intervals
        if b > end:
            busy_us += b - max(a, end)
            end = b
    by_name: dict[str, list] = {}
    for e in dev:
        ent = by_name.setdefault(e.name, [0, 0.0])
        ent[0] += 1
        ent[1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    span_us = spans[-1][1] - spans[0][0]
    return dict(fields, window_ms=wall_ms, device_events=len(dev),
                device_time_visible=True, device_busy_ms=busy_us / 1e3,
                busy_share=busy_us / 1e3 / wall_ms,
                device_span_ms=span_us / 1e3,
                busy_share_of_span=busy_us / span_us,
                top_kernels=[dict(name=k[:160], count=c, ms=us / 1e3)
                             for k, (c, us) in top])


def sync_bytes(V, K, G, wire: str) -> int:
    """Bytes a rank sends (and receives) to sync one (V, K) int32 delta
    over G ranks: a ring all-reduce moves 2 (G - 1) / G of the int32
    array; the byte wire (a reduce-scatter and an all-gather of the int16
    array) half that.  0 on one rank."""
    return int(2 * (G - 1) / G * V * K * (4 if wire == "int32" else 2))


def mesh_phases(card, corpus, shard, seg, rows, st, single_tps,
                counters) -> dict:
    """Phase 15: training over a one-rank NCCL group (a ``file://`` store)
    through ``fit(mesh=...)``; returns the K1 / K2 / K4 launches of its
    mesh runs.  ``shard``, ``seg``, ``rows`` are phase 7's tiling and
    tables, ``st`` phase 11's final state, ``single_tps`` its median
    tokens/s."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import lda_nytimes
    from repro_torch.core import sync, trainer, updates
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.distributed import partition
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.train import fit

    cfg = trainer.resolve_config(lda_nytimes.CONFIG, corpus)
    V, K = corpus.num_words, cfg.num_topics
    tw, tf, tm = shard.tile_word, shard.tile_first, shard.token_mask
    launched = {f.__name__: 0 for f in counters}

    def run(corp, c, iters, mesh, rebuild=None, **kw):
        """One mesh fit and, as phase 11 does, ``rebuild`` (K4 on its final
        z), the launches read around both; the counts and the LL
        checked."""
        for f in counters:
            f.launches = 0
        t0 = time.perf_counter()
        res = fit(corp, c, iters, mesh, eval_every=1, **kw)
        if rebuild is not None and not torch.equal(res.state.phi_vk,
                                                   rebuild(res.state.z)):
            raise AssertionError("phi != K4(z) after a mesh run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = {f.__name__: f.launches for f in counters}
        for k in launched:
            launched[k] += n[k]
        if n["lda_sample_tiles"] != iters + 1 or \
                n["phi_delta_tiles"] != iters + 1:
            raise AssertionError(f"mesh run: K1/K2 not launched once per "
                                 f"iteration (+1 warm-up): {n}")
        if not res.ll_per_token[-1] > res.ll_per_token[0]:
            raise AssertionError(f"mesh LL/token did not rise: "
                                 f"{res.ll_per_token}")
        s = res.state
        if not torch.equal(s.phi_sum, updates.phi_totals(s.phi_vk)) or \
                int(s.phi_vk.sum(dtype=torch.int64)) != corp.num_tokens:
            raise AssertionError("mesh run: phi_sum or phi.sum() is off")
        tps = res.tokens_per_sec
        return res, dict(iters=iters, compile_sec=res.compile_sec,
                         tokens_per_sec=tps,
                         median_tokens_per_sec=float(np.median(tps)),
                         ll_per_token=res.ll_per_token, launches=n,
                         wall_s=wall)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh(1)
            init_s = time.perf_counter() - t0
            try:             # fault F4: does NCCL take int16?
                x = torch.ones(4, dtype=torch.int16, device=shard.device)
                dist.all_reduce(x)
                torch.cuda.synchronize()
                int16 = "accepted"
            except (RuntimeError, TypeError, ValueError) as e:
                int16 = f"refused: {type(e).__name__}: {str(e)[:160]}"

            # one mesh step against lda_iteration, with the uniforms the
            # single-device path draws at phase 11's final state
            t0 = time.perf_counter()
            dl = partition.DistributedLDA(lda_nytimes.CONFIG, mesh, corpus,
                                          mode="1d", doc_axes=("data",),
                                          word_axes=())
            build_s = time.perf_counter() - t0
            same_tiling = all(torch.equal(getattr(dl.shard, f),
                                          getattr(shard, f))
                              for f in ("tile_word", "token_doc",
                                        "token_mask", "tile_first",
                                        "token_uid"))
            u = trainer.iteration_uniforms(cfg, st)
            a, _ = dl.step(st, u)
            b, _ = trainer.lda_iteration(cfg, shard, st, u)
            torch.cuda.synchronize()
            step_equal = (torch.equal(a.z, b.z)
                          and torch.equal(a.phi_vk, b.phi_vk)
                          and torch.equal(a.phi_sum, b.phi_sum))
            # one iteration's delta over the group: both wires, timed
            moved = int(((a.z != st.z) & tm).sum())
            delta = a.phi_vk - st.phi_vk
            heavy = torch.from_numpy(partition.heavy_word_rows(
                corpus, dl.plan)[0].astype(np.int64)).to(shard.device)
            wire_equal = torch.equal(
                sync.compressed_sync_phi(delta, dl.data_group, heavy), delta)
            d32 = delta.clone()
            sync_ms = dict(
                int32=time_ms(lambda: sync.sync_phi_delta(d32,
                                                          dl.data_group)),
                bytes=time_ms(lambda: sync.compressed_sync_phi(
                    delta, dl.data_group, heavy)))
            del dl, a, b, u, delta, d32
            emit("mesh_step", card=card, nccl_init_s=init_s,
                 nccl_int16=int16, partition_build_s=build_s,
                 same_tiling=same_tiling, step_equal=step_equal,
                 wire_equal=wire_equal, heavy_rows=int(heavy.numel()),
                 moved_tokens=moved, sync_ms=sync_ms,
                 sync_bytes_per_rank={w: sync_bytes(V, K, 1, w)
                                      for w in ("int32", "bytes")},
                 sync_bytes_per_rank_at_4={w: sync_bytes(V, K, 4, w)
                                           for w in ("int32", "bytes")})
            if not (same_tiling and step_equal and wire_equal):
                raise AssertionError("the mesh step differs from "
                                     "lda_iteration, or the byte wire from "
                                     "the delta")

            # fit(mesh=...) at full width, both wires
            def k4(z):
                return phi_ops.phi_update(tw, tf, z, tm, num_words=V,
                                          num_topics=K, segments=seg,
                                          zero_rows=rows)

            runs, first = {}, None
            for comp in (False, True):
                c = dataclasses.replace(lda_nytimes.CONFIG,
                                        compressed_sync=comp)
                res, runs["bytes" if comp else "int32"] = run(
                    corpus, c, MESH_ITERS, mesh, rebuild=k4)
                if runs["bytes" if comp else "int32"]["launches"][
                        "phi_update_tiles"] < 1:
                    raise AssertionError("K4 was not launched after a mesh "
                                         "run")
                z = res.state.z
                if first is None:
                    first = (z, res.state.phi_vk)
                elif not (torch.equal(first[0], z)
                          and torch.equal(first[1], res.state.phi_vk)):
                    raise AssertionError("the two wires trained different "
                                         "states")
                del res, z
            del first
            emit("mesh_train", card=card, runs=runs,
                 single_device_median_tokens_per_sec=single_tps,
                 mesh_over_single={k: r["median_tokens_per_sec"] / single_tps
                                   for k, r in runs.items()})

            # the 2d path on a 1 x 1 mesh, smaller corpus
            mesh2 = init_device_mesh("cuda", (1, 1),
                                     mesh_dim_names=("data", "model"))
            small = nytimes_like(MESH_2D_SCALE, seed=0)
            _, run2d = run(small, dataclasses.replace(
                lda_nytimes.CONFIG, compressed_sync=True), MESH_2D_ITERS,
                mesh2, mode="2d", doc_axes=("data",), word_axes=("model",))
            emit("mesh_train_2d", card=card, scale=MESH_2D_SCALE,
                 tokens=small.num_tokens, **run2d)
        finally:
            dist.destroy_process_group()
    return launched


def counts_vs_plain(phase, shard, seg, rows, state0, z1, V, K,
                    reuse: bool) -> tuple[int, int]:
    """K2 (z1 - state0.z) and K4 (z1) against their plain versions at full
    V x K, and state0.phi + K2 == K4(z1); with ``reuse``, K4 also into
    memory the allocator has just freed from a tensor of -1 (a row K4
    neither writes whole nor zeroes shows there).  Emits ``phase``, raises
    past exactness, returns (K2's, K4's max abs error)."""
    import torch

    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ref as k24_ref

    tw, tf, tm = shard.tile_word, shard.tile_first, shard.token_mask
    dev = tm.device
    dk = k24.phi_delta_tiles(seg, z1, state0.z, tm, V, K)
    dr = k24_ref.phi_delta_tiles_ref(tw, tf, z1, state0.z, tm, V, K)
    ur = k24_ref.phi_update_tiles_ref(tw, tf, z1, tm, V, K)
    uk = k24.phi_update_tiles(seg, rows, z1, tm, V, K)
    torch.cuda.synchronize()
    k4_err = int((uk - ur).abs().max())
    update_equal = torch.equal(uk, ur)
    reused = extra = None
    if reuse:
        # K4 writes rows it does not zero: into memory the allocator has
        # just freed from a tensor of -1, a row it failed to own shows as -1s
        del uk
        torch.cuda.empty_cache()
        junk = torch.full((V, K), -1, dtype=torch.int32, device=dev)
        junk_ptr = junk.data_ptr()
        del junk
        uk = k24.phi_update_tiles(seg, rows, z1, tm, V, K)
        reused = uk.data_ptr() == junk_ptr
        torch.cuda.synchronize()
        k4_err = max(k4_err, int((uk - ur).abs().max()))
        extra = dict(update_equal_in_reused_memory=torch.equal(uk, ur),
                     reused_memory=reused)
    k2_err = int((dk - dr).abs().max())
    delta_equal, advance = torch.equal(dk, dr), torch.equal(
        state0.phi_vk + dk, uk)
    emit(phase, V=V, K=K, delta_equal=delta_equal, update_equal=update_equal,
         **(extra or {}), advance_exact=advance,
         moved_tokens=int(((z1 != state0.z) & tm).sum()),
         k2_max_abs_err=k2_err, k4_max_abs_err=k4_err)
    if not (delta_equal and update_equal and torch.equal(uk, ur)
            and advance):
        raise AssertionError("K2 / K4 differ from their plain versions")
    if reuse and not reused:
        raise AssertionError("K4's -1 check did not get the freed memory")
    return k2_err, k4_err


def trained_state_phases(card, cfg, shard, st, seg, kw, label: str,
                         phase: str):
    """On a trained state ``st``: K1 against its plain version
    (``k1_vs_plain``, state ``label``), then each step of ``lda_iteration``
    timed alone (``time_ms``, 5 calls) with K1's bound and design bytes on
    that state; emits ``phase``.  Returns (K1's largest S/(S+Q) error where
    the draws agree, the step times)."""
    import torch

    from repro_torch.core import trainer, updates
    from repro_torch.core.sampler import draw_sweep_uniforms, pick_search_block
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.phi_update import kernel as k24

    tw, tm = shard.tile_word, shard.token_mask
    n, t = tm.shape
    V, K = shard.num_words, cfg.num_topics
    nb, bw = K // pick_search_block(K), pick_search_block(K)
    # the two steps that build a (D, K) theta of their own are timed
    # before this one's theta exists (at PubMed's depth two do not fit)
    torch.cuda.empty_cache()
    ms = dict(
        theta_from_z=time_ms(lambda: updates.theta_from_z(
            st.z, shard.token_doc, tm, shard.num_docs_local, K), n=5, warm=1),
        log_likelihood=time_ms(lambda: trainer.log_likelihood(cfg, shard, st),
                               n=5, warm=1))
    theta, c, tp, _ = trainer.theta_and_ell(cfg, shard, st.z)
    P = c.shape[1]
    live = k1_ops.live_lengths(c)
    gen = trainer.iteration_generator(cfg, st.iteration, tm.device)
    u = draw_sweep_uniforms(gen, n, t)
    fin = (tw, shard.token_doc, tm, st.z, st.phi_vk, st.phi_sum, c, tp, u)
    err = k1_vs_plain(fin, kw, label)

    z2, sp2, _ = k1.lda_sample_tiles(*fin, ell_live=live, **kw)
    d2 = k24.phi_delta_tiles(seg, z2, st.z, tm, V, K)
    steps = dict(
        theta_to_ell=lambda: updates.theta_to_ell(theta, P, c.dtype),
        draw_uniforms=lambda: draw_sweep_uniforms(gen, n, t),
        live_lengths=lambda: k1_ops.live_lengths(c),
        k1_sweep=lambda: k1.lda_sample_tiles(*fin, ell_live=live, **kw),
        k2_phi_delta=lambda: k24.phi_delta_tiles(seg, z2, st.z, tm, V, K),
        phi_advance=lambda: updates.phi_totals(st.phi_vk + d2))
    ms.update({k: time_ms(f, n=5, warm=1) for k, f in steps.items()})
    it_ms = sum(v for k, v in ms.items() if k != "log_likelihood")
    emit(phase, card=card, iteration=st.iteration, ms=ms, iteration_ms=it_ms,
         shares={k: v / it_ms for k, v in ms.items()
                 if k != "log_likelihood"},
         k1_final_bound=bound(*k1_bytes_and_ops(fin, sp2, nb, bw),
                              FP32_FLOPS),
         k1_design=k1_design(fin, ms["k1_sweep"], k1.tiles_per_cta()),
         sparse_share=float(sp2[tm].float().mean()))
    del z2, sp2, d2, fin, u, theta, c, tp, live
    torch.cuda.empty_cache()
    return err, ms


def pubmed_phase(card: str, scale: float, iters: int, counters,
                 device="cuda:0") -> tuple[dict, int, int, float]:
    """Phase 17: ``configs/lda_pubmed.CONFIG`` on ``lda_pubmed.scaled(scale)``
    at full width (V = 141,043, K = 1024): host preparation, K1, K2 and K4
    and the ELL kernel against their plain versions on this tiling, ``fit``
    for ``iters``
    iterations (the launches read around it), phi == K4(z), the step
    breakdown on the final state, and the peak device memory of the phase.
    Returns (the launches of its main path, K2's and K4's max abs error,
    K1's S/(S+Q) error)."""
    import numpy as np
    import torch

    from repro_torch.configs import lda_pubmed
    from repro_torch.core import trainer, updates
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.core.sampler import draw_sweep_uniforms
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.train import fit

    dev = torch.device(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    corpus = lda_pubmed.scaled(scale, seed=0)
    t_corpus = time.perf_counter() - t0
    cfg = trainer.resolve_config(lda_pubmed.CONFIG, corpus)
    t0 = time.perf_counter()
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0]
    t_tile = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard = shard.to(dev)
    seg = phi_ops.shard_segments(shard)
    rows = phi_ops.shard_rows_to_zero(shard)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    n, t = shard.token_doc.shape
    V, K, P = corpus.num_words, cfg.num_topics, cfg.ell_capacity
    ell = updates.ell_dtype(K, shard.max_doc_length)
    emit("pubmed_prep", card=card, scale=scale, docs=corpus.num_docs, V=V,
         K=K, P=P, tokens=corpus.num_tokens, tiles=n, tile_tokens=t,
         max_doc_length=shard.max_doc_length, ell_dtype=str(ell),
         corpus_s=t_corpus, tiling_s=t_tile, to_device_s=t_dev,
         k2_segments=int(seg.shape[0]), k4_rows_to_zero=int(rows.shape[0]))
    if V != lda_pubmed.FULL["num_words"] or K != lda_pubmed.NUM_TOPICS:
        raise AssertionError(f"PubMed is not at full width: V={V}, K={K}")

    # K1, K2, K4 and the ELL against their plain versions on this tiling
    state0 = trainer.init_state(cfg, shard)
    theta0, ell_c, ell_t, _ = trainer.theta_and_ell(cfg, shard, state0.z)
    ell_vs_plain(theta0, P, ell, "pubmed-initial")
    del theta0
    live0 = k1_ops.live_lengths(ell_c)
    uni = draw_sweep_uniforms(trainer.iteration_generator(cfg, 0, dev), n, t)
    full = (shard.tile_word, shard.token_doc, shard.token_mask, state0.z,
            state0.phi_vk, state0.phi_sum, ell_c, ell_t, uni)
    kw = dict(alpha=cfg.resolved_alpha(), beta=cfg.beta, num_words_total=V)
    k1_err = k1_vs_plain(full, kw, "pubmed-initial")
    z1 = k1.lda_sample_tiles(*full, ell_live=live0, **kw)[0]
    k2_err, k4_err = counts_vs_plain("pubmed_counts_vs_plain", shard, seg,
                                     rows, state0, z1, V, K, reuse=False)
    del state0, ell_c, ell_t, live0, uni, full, z1
    torch.cuda.empty_cache()

    # the main path: fit, then K4 rebuilds phi from the final z
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    res = fit(corpus, lda_pubmed.CONFIG, iters, device=dev, shard=shard,
              eval_every=1)
    st = res.state
    rebuilt = phi_ops.phi_update(shard.tile_word, shard.tile_first, st.z,
                                 shard.token_mask, num_words=V, num_topics=K,
                                 segments=seg, zero_rows=rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    peak = torch.cuda.max_memory_allocated(dev)
    tps = res.tokens_per_sec
    emit("pubmed_train", card=card, scale=scale, iters=iters,
         compile_sec=res.compile_sec, tokens_per_sec=tps,
         median_tokens_per_sec=float(np.median(tps)),
         ll_per_token=res.ll_per_token,
         sparse_frac=[x[0] for x in res.stats],
         mean_s_over_sq=[x[2] for x in res.stats], launches=launches,
         wall_s=wall, peak_bytes=peak,
         total_memory=torch.cuda.get_device_properties(dev).total_memory)
    if launches["lda_sample_tiles"] != iters + 1 or \
            launches["phi_delta_tiles"] != iters + 1 or \
            launches["phi_update_tiles"] < 1 or \
            launches["ell_select"] < iters + 1:
        raise AssertionError(f"PubMed: K1/K2 not launched once per iteration"
                             f" (+1 warm-up), the ELL kernel less often, or "
                             f"K4 never: {launches}")
    if not res.ll_per_token[-1] > res.ll_per_token[0]:
        raise AssertionError(f"PubMed LL/token did not rise: "
                             f"{res.ll_per_token}")
    if not (torch.equal(st.phi_vk, rebuilt)
            and torch.equal(st.phi_sum, updates.phi_totals(st.phi_vk))
            and int(st.phi_vk.sum(dtype=torch.int64)) == corpus.num_tokens
            and bool(((st.z >= 0) & (st.z < K)).all())):
        raise AssertionError("PubMed: phi != K4(z), or its sums or z are "
                             "off")
    del rebuilt
    err, _ = trained_state_phases(card, cfg, shard, st, seg, kw,
                                  "pubmed-trained", "pubmed_breakdown")
    return launches, k2_err, k4_err, max(k1_err, err)


def examples_phase(card: str, counters) -> dict:
    """Phase 18: ``examples/torch_quickstart.py`` and
    ``examples/torch_serve_lda.py`` through their ``main`` on cuda:0 at
    their default sizes; returns the launches of the four kernels in
    them."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_quickstart
    import torch_serve_lda

    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    quick = torch_quickstart.main([])
    t_quick = time.perf_counter() - t0
    quick_launches = {f.__name__: f.launches for f in counters}
    t0 = time.perf_counter()
    served = torch_serve_lda.main([])
    t_serve = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    emit("examples", card=card, quickstart_s=t_quick,
         quickstart_ll=quick.ll_per_token,
         quickstart_launches=quick_launches, serve_s=t_serve,
         serve_version=served["version"],
         serve_swapped_version=int(served["swapped"]["model_version"]),
         serve_perplexity=float(served["perplexity"].perplexity),
         launches=launches)
    if quick_launches["lda_sample_tiles"] < 1 or \
            quick_launches["phi_delta_tiles"] < 1:
        raise AssertionError(f"the quickstart missed K1/K2: {quick_launches}")
    if launches["fold_in_docs"] < 1:
        raise AssertionError("the serving example never launched K3")
    if not quick.ll_per_token[-1] > quick.ll_per_token[0]:
        raise AssertionError("the quickstart's LL/token did not rise")
    if served["version"] != 3 or not np.isfinite(
            served["perplexity"].perplexity):
        raise AssertionError("the serving example did not swap to v3")
    return launches


def lm_run(cfg, params, state, batch: dict, tokens, dev):
    """The port's prefill of ``batch`` and the decode of ``tokens`` (B, n)
    from ``state``, on ``dev`` from copies of the given trees: (prefill
    logits, the n steps' logits (B, n, V), the final state)."""
    import torch

    from repro_torch.models import zoo
    from repro_torch.models.common import tree_map

    mv = lambda tree: tree_map(lambda a: a.to(dev, copy=True), tree)  # noqa: E731
    params, state = mv(params), mv(state)
    pre = zoo.make_prefill_step(cfg)(
        params, {k: v.to(dev) for k, v in batch.items()})
    step = zoo.make_decode_step(cfg)
    outs = []
    for i in range(tokens.shape[1]):
        logits, state = step(params, state, tokens[:, i:i + 1].to(dev))
        outs.append(logits)
    return pre, torch.cat(outs, 1), state


def rel_err(got, ref, vocab: int) -> float:
    """max |got - ref| over the real vocabulary, relative to max |ref|."""
    got, ref = got[..., :vocab].float().cpu(), ref[..., :vocab].float().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def decode_vs_prefill(cfg, params, prompt, dev, max_len: int,
                      frames=None) -> float:
    """A prompt decoded token by token from an empty state against the
    prefill's last logits (whisper decodes against its encoder's K/V)."""
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo

    batch = {"tokens": prompt}
    state = zoo.init_decode_state(cfg, prompt.shape[0], max_len,
                                  dtype=cfg.dtype, device=dev)
    if frames is not None:
        batch["frames"] = frames
        state = state._replace(cross_kv=zoo.cross_kv_from_encoder(
            params, cfg, tf.encode(params, cfg, frames), cfg.dtype))
    pre = zoo.make_prefill_step(cfg)(params, batch)
    step = zoo.make_decode_step(cfg)
    for i in range(prompt.shape[1]):
        logits, state = step(params, state, prompt[:, i:i + 1])
    return rel_err(logits, pre, cfg.vocab_size)


def lm_arch_vs_cpu(name: str, dev) -> dict:
    """Phase 19 for one architecture at its smoke() width, float32 (TF32
    off): weights and a stand-in state of LM_PREFILL tokens drawn on the
    CPU from a seed; a prefill of LM_S tokens and LM_STEPS decode steps
    (max_len LM_MAX, so a window-8 ring wraps) on ``dev`` and on the CPU;
    and, but for the MoE archs (their capacity depends on the token count,
    so decode and prefill drop different routings, as in the reference),
    the decode of an LM_S-token prompt against its prefill on ``dev``."""
    import dataclasses

    import torch

    from repro_torch.configs.archs import smoke
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.common import tree_map
    from repro_torch.models.convert import flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(smoke(name), dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    params = tf.init_params(cfg, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (LM_B, LM_S),
                                     generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(LM_B, cfg.encoder_frames, cfg.d_model,
                                      generator=gen)
    if cfg.vision_tokens:
        batch["patches"] = torch.randn(LM_B, cfg.vision_tokens, cfg.d_model,
                                       generator=gen)
    state = zoo.init_decode_state(cfg, LM_B, LM_MAX, prefill_len=LM_PREFILL,
                                  generator=gen, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (LM_B, LM_STEPS),
                           generator=gen)
    card = lm_run(cfg, params, state, batch, tokens, dev)
    host = lm_run(cfg, params, state, batch, tokens, torch.device("cpu"))
    hs = flatten(host[2])
    state_err = max(float((a.cpu().double() - hs[k].double()).abs().max())
                    for k, a in flatten(card[2]).items())
    row = dict(arch=name, prefill_rel_err=rel_err(card[0], host[0],
                                                  cfg.vocab_size),
               decode_rel_err=rel_err(card[1], host[1], cfg.vocab_size),
               state_max_abs_err=state_err,
               position=int(card[2].position),
               finite=bool(torch.isfinite(card[1].float()).all()))
    if not cfg.is_moe:
        pd = tree_map(lambda a: a.to(dev), params)
        row["decode_vs_prefill_rel_err"] = decode_vs_prefill(
            cfg, pd, batch["tokens"].to(dev), dev, LM_MAX,
            batch["frames"].to(dev) if cfg.encoder_layers else None)
    return row


def lm_archs_phase(card: str, dev="cuda:0") -> None:
    """Phase 19: every architecture of configs/archs.py at smoke() width,
    the card against the CPU (``lm_arch_vs_cpu``)."""
    import torch

    from repro_torch.configs.archs import ARCHS

    t0 = time.perf_counter()
    rows = [lm_arch_vs_cpu(name, torch.device(dev)) for name in ARCHS]
    emit("lm_archs", card=card, archs=rows, seconds=time.perf_counter() - t0)
    for r in rows:
        bad = [k for k in ("prefill_rel_err", "decode_rel_err",
                           "decode_vs_prefill_rel_err")
               if r.get(k, 0.0) > LM_ARCH_REL]
        if bad or not r["finite"] or r["position"] != LM_PREFILL + LM_STEPS:
            raise AssertionError(f"{r['arch']}: {bad or r}")


def cache_bytes(state) -> int:
    """Bytes of the KV caches' keys and values (the reference's ``_sdpa``
    reads every slot of a cache each decode step)."""
    from repro_torch.models.convert import flatten

    return sum(a.numel() * a.element_size() for k, a in
               flatten(state).items() if k.endswith((".k", ".v")))


def qwen_phase(card: str, dev="cuda:0") -> None:
    """Phase 20: qwen3-4b at full width on the card, weights drawn from a
    seeded generator there (bf16, the config's dtype).  (a) float32 (the
    same weights cast, TF32 off): a QWEN_PROMPT-token prompt's prefill
    against its decode token by token (max_len 2 * QWEN_PROMPT); (b) bf16
    against that float32 model, QWEN_BF16_STEPS teacher-forced decode
    steps; (c) serving: stand-in caches of QWEN_PREFILL tokens (max_len
    QWEN_MAX) at each of QWEN_BATCHES, QWEN_STEPS greedy bf16 steps timed,
    beside the step's bytes bound, then ``torch.profiler`` over
    QWEN_PROFILED steps; (d) a prefill of QWEN_S tokens (batch 1, the
    chunked causal path) beside its FLOP bound.  Everything is freed at
    the end."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.archs import QWEN3_4B as cfg
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.common import padded_vocab, tree_map
    from repro_torch.models.convert import flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = flatten(params)
    n_params = sum(a.numel() for a in leaves.values())
    w_bytes = sum(a.numel() * a.element_size() for a in leaves.values())
    V = cfg.vocab_size
    step = zoo.make_decode_step(cfg)
    prefill = zoo.make_prefill_step(cfg)

    # (a) float32: decode token by token == prefill
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = tree_map(lambda a: a.float(), params)
    step32 = zoo.make_decode_step(c32)
    prompt = torch.randint(0, V, (2, QWEN_PROMPT), generator=gen, device=dev)
    f32_rel = decode_vs_prefill(c32, p32, prompt, dev, 2 * QWEN_PROMPT)

    # (b) bf16 against float32 of the same weights, teacher-forced
    s16 = zoo.init_decode_state(cfg, 2, QWEN_BF16_STEPS, device=dev)
    s32 = zoo.init_decode_state(c32, 2, QWEN_BF16_STEPS, dtype=torch.float32,
                                device=dev)
    errs, agree = [], 0
    for i in range(QWEN_BF16_STEPS):
        l16, s16 = step(params, s16, prompt[:, i:i + 1])
        l32, s32 = step32(p32, s32, prompt[:, i:i + 1])
        errs.append(rel_err(l16, l32, V))
        agree += int((l16[..., :V].argmax(-1) == l32[..., :V].argmax(-1))
                     .sum())
    bf16_rel = max(errs)
    top1 = agree / (2 * QWEN_BF16_STEPS)
    del p32, s16, s32, l16, l32
    torch.cuda.empty_cache()

    # (c) serving: greedy bf16 decode against stand-in caches
    serve = []
    for B in QWEN_BATCHES:
        st = zoo.init_decode_state(cfg, B, QWEN_MAX, prefill_len=QWEN_PREFILL,
                                   generator=gen)
        tok = torch.randint(0, V, (B, 1), generator=gen, device=dev)
        for _ in range(2):                                   # warm-up
            logits, st = step(params, st, tok)
            tok = logits[..., :V].argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(QWEN_STEPS):
            logits, st = step(params, st, tok)
            tok = logits[..., :V].argmax(-1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        kv = cache_bytes(st)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(QWEN_PROFILED):
                logits, st = step(params, st, tok)
                tok = logits[..., :V].argmax(-1)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t1) * 1e3
        busy = device_busy(prof, prof_ms, steps=QWEN_PROFILED)
        busy["top_kernels"] = busy.get("top_kernels", [])[:5]
        serve.append(dict(
            batch=B, steps=QWEN_STEPS, tokens_per_s=B * QWEN_STEPS / wall,
            ms_per_step=wall / QWEN_STEPS * 1e3, weight_bytes=w_bytes,
            kv_cache_bytes=kv,
            bound_ms=(w_bytes + kv) / HBM_BYTES_PER_S * 1e3,
            position=int(st.position),
            finite=bool(torch.isfinite(logits.float()).all()), profile=busy))
        del st, logits
        torch.cuda.empty_cache()

    # (d) prefill of QWEN_S tokens, batch 1 (the chunked causal path)
    toks = torch.randint(0, V, (1, QWEN_S), generator=gen, device=dev)
    pre = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(QWEN_PREFILL_CALLS):
        pre = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    pre_s = (time.perf_counter() - t0) / QWEN_PREFILL_CALLS
    vp = padded_vocab(V)
    # dense FLOPs: every weight but the embedding's gather once a token,
    # the tied head on the last token, causal attention (QK and PV on
    # half the S x S pairs)
    flops = (2 * (n_params - vp * cfg.d_model) * QWEN_S
             + 2 * cfg.d_model * vp
             + 2 * QWEN_S * QWEN_S * cfg.num_heads * cfg.hd * cfg.num_layers)
    peak = torch.cuda.max_memory_allocated(dev)
    emit("lm_qwen3_4b", card=card, arch=cfg.name, layers=cfg.num_layers,
         d_model=cfg.d_model, heads=cfg.num_heads, kv_heads=cfg.num_kv_heads,
         head_dim=cfg.hd, d_ff=cfg.d_ff, vocab=V, padded_vocab=vp,
         params=n_params, weight_bytes=w_bytes, init_s=init_s,
         f32_decode_vs_prefill_rel_err=f32_rel, f32_prompt=QWEN_PROMPT,
         bf16_vs_f32_rel_err=bf16_rel, bf16_vs_f32_step_errs=errs,
         bf16_top1_agreement=top1, serve=serve,
         prefill=dict(batch=1, S=QWEN_S, ms=pre_s * 1e3,
                      tokens_per_s=QWEN_S / pre_s, flops=flops,
                      bound_ms=flops / BF16_FLOPS * 1e3,
                      finite=bool(torch.isfinite(pre.float()).all())),
         peak_bytes=peak)
    del params, pre, leaves, prompt, toks
    torch.cuda.empty_cache()
    if f32_rel > QWEN_F32_REL:
        raise AssertionError(f"qwen3-4b float32 decode vs prefill {f32_rel}")
    if bf16_rel > QWEN_BF16_REL:
        raise AssertionError(f"qwen3-4b bf16 vs float32 {bf16_rel}")
    for row in serve:
        if not row["finite"] or row["position"] != (
                QWEN_PREFILL + 2 + QWEN_STEPS + QWEN_PROFILED):
            raise AssertionError(f"qwen3-4b serving at B = {row['batch']}")
    if n_params != QWEN_PARAMS:
        raise AssertionError(f"qwen3-4b has {n_params} parameters")


def lm_launcher_phase(card: str) -> None:
    """Phase 21: ``repro_torch.launch.serve.main`` on cuda:0 at the
    reference's defaults (batch 8, 16 steps, max_len 128) for qwen3-4b and
    mamba2-130m."""
    from repro_torch.launch import serve

    rows = []
    for arch in ("qwen3-4b", "mamba2-130m"):
        t0 = time.perf_counter()
        out = serve.main(["--arch", arch])
        rows.append(dict(out, wall_s=time.perf_counter() - t0))
    emit("lm_serve_launcher", card=card, runs=rows)
    for r in rows:
        if not r["finite"] or r["position"] != 17 or \
                not r["device"].startswith("cuda"):
            raise AssertionError(f"launcher: {r}")


def lr_at(step: int) -> float:
    """AdamW's learning rate at ``step`` (1-based) under the default
    config's linear warmup."""
    from repro_torch.optim import adamw

    cfg = adamw.AdamWConfig()
    return cfg.lr * min(step / max(cfg.warmup_steps, 1), 1.0)


def train_steps(cfg, params, batch: dict, dev, steps: int) -> list:
    """``steps`` ``train_step``s on ``dev`` from a copy of ``params`` and a
    fresh AdamW state on one batch: per step, (loss, grad norm, the state
    flattened and copied to the CPU as float64)."""
    import torch

    from repro_torch.models import zoo
    from repro_torch.models.common import tree_map
    from repro_torch.models.convert import flatten
    from repro_torch.optim import adamw

    params = tree_map(lambda a: a.detach().to(dev, copy=True), params)
    batch = {k: v.to(dev) for k, v in batch.items()}
    state = zoo.TrainState(params, adamw.init(params))
    step = zoo.make_train_step(cfg)
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: a.detach().to("cpu", torch.float64, copy=True)
                     for k, a in flatten(state).items()}))
    return out


def lm_train_vs_cpu(name: str, dev) -> dict:
    """Phase 22 for one architecture at its smoke() width: float32 (TF32
    off), weights and a batch drawn on the CPU from a seed, LM_TRAIN_STEPS
    train steps on ``dev`` and on the CPU from the same state on the same
    batch; then the bf16 config, two steps on ``dev`` on that batch."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs.archs import smoke
    from repro_torch.models import transformer as tf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg16 = smoke(name)
    cfg = dataclasses.replace(cfg16, dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    params = tf.init_params(cfg, gen)
    B, S = LM_TRAIN_B, LM_TRAIN_S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(B, cfg.encoder_frames, cfg.d_model,
                                      generator=gen)
    if cfg.vision_tokens:
        batch["patches"] = torch.randn(B, cfg.vision_tokens, cfg.d_model,
                                       generator=gen)
    card = train_steps(cfg, params, batch, dev, LM_TRAIN_STEPS)
    host = train_steps(cfg, params, batch, torch.device("cpu"),
                       LM_TRAIN_STEPS)
    loss_err = norm_err = 0.0
    excess = -math.inf             # the largest state error over its bound
    state_err = 0.0
    steps_equal = True
    for i, ((cl, cn, cs), (hl, hn, hs)) in enumerate(zip(card, host), 1):
        loss_err = max(loss_err, abs(cl - hl) / abs(hl))
        norm_err = max(norm_err, abs(cn - hn) / hn)
        bound = sum(2 * lr_at(t) for t in range(1, i + 1)) + LM_STATE_ATOL
        for k, a in cs.items():
            if k == "opt.step":
                steps_equal &= int(a) == int(hs[k]) == i
                continue
            e = float((a - hs[k]).abs().max())
            state_err = max(state_err, e)
            excess = max(excess, e - bound)
    p16 = tf.init_params(cfg16, torch.Generator().manual_seed(SEED))
    bf16 = train_steps(cfg16, p16, batch, dev, 2)
    return dict(arch=name, loss=[c[0] for c in card],
                loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                state_max_abs_err=state_err, state_within_bound=excess <= 0,
                steps_equal=steps_equal, bf16_losses=[b[0] for b in bf16],
                finite=all(math.isfinite(c[0]) and math.isfinite(c[1])
                           for c in card + bf16))


def lm_train_archs_phase(card: str, dev="cuda:0") -> None:
    """Phase 22: every architecture's train step, the card against the CPU
    (``lm_train_vs_cpu``)."""
    import torch

    from repro_torch.configs.archs import ARCHS

    t0 = time.perf_counter()
    rows = [lm_train_vs_cpu(name, torch.device(dev)) for name in ARCHS]
    emit("lm_train_archs", card=card, archs=rows,
         seconds=time.perf_counter() - t0)
    for r in rows:
        if (r["loss_rel_err"] > LM_LOSS_REL or r["grad_norm_rel_err"] >
                LM_NORM_REL or not r["state_within_bound"]
                or not r["steps_equal"] or not r["finite"]
                or not r["bf16_losses"][1] < r["bf16_losses"][0]
                + LM_TWO_STEP_RISE):
            raise AssertionError(f"{r['arch']} training: {r}")


def qwen_train_flops(cfg, n_params: int, tokens: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N T for the weights (N the
    parameter tensors' count, norms included; the tied head's product
    included, the embedding's gather counted as a product too), plus the
    attention's score and PV products as executed (every query chunk
    against all ``seq`` keys: the reference's recipe does not skip masked
    blocks), forward and backward (3x the forward).  The recomputation of
    the blocks and CE chunks in the backward is not counted."""
    attn_fwd = (4 * tokens * seq * cfg.num_heads * cfg.hd * cfg.num_layers
                if cfg.num_heads else 0)          # attention-free (mamba2)
    return 6 * n_params * tokens + 3 * attn_fwd


def qwen_train_phase(card: str, dev="cuda:0") -> list:
    """Phase 23: qwen3-4b training at full width on the card (see the
    module docstring); everything is freed at the end.  Returns the
    losses, in the order of the batches."""
    import math

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.configs.archs import QWEN3_4B as cfg
    from repro_torch.data.loader import PrefetchLoader, lm_batches
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw

    dev = torch.device(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(SEED))
    state = zoo.TrainState(params, adamw.init(params))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = lambda tree: sum(a.numel() * a.element_size()  # noqa: E731
                              for a in tree_leaves(tree))
    n_params = sum(a.numel() for a in tree_leaves(params))
    param_bytes = nbytes(params)
    opt_bytes = nbytes(state.opt)
    B, S = QWEN_TRAIN_B, QWEN_TRAIN_S
    step = zoo.make_train_step(cfg)
    loader = PrefetchLoader(lm_batches(cfg.vocab_size, B, S, seed=SEED),
                            device=dev)
    losses, norms = [], []
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    try:
        for _ in range(QWEN_TRAIN_WARM):
            state, m = step(state, next(loader))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        a, b = ev(), ev()
        t0 = time.perf_counter()
        a.record()
        for _ in range(QWEN_TRAIN_TIMED):
            state, m = step(state, next(loader))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        b.record()
        b.synchronize()
        wall_s = (time.perf_counter() - t0) / QWEN_TRAIN_TIMED
        step_ms = a.elapsed_time(b) / QWEN_TRAIN_TIMED

        # forward + backward and the optimizer apart
        fb, opt = [], []
        for _ in range(QWEN_TRAIN_SPLIT):
            batch = next(loader)
            e0, e1, e2 = ev(), ev(), ev()
            e0.record()
            loss, grads = zoo.loss_and_grads(state.params, cfg, batch)
            e1.record()
            _, _, gnorm = adamw.apply(adamw.AdamWConfig(), grads, state.opt,
                                      state.params)
            e2.record()
            del grads
            e2.synchronize()
            fb.append(e0.elapsed_time(e1))
            opt.append(e1.elapsed_time(e2))
            losses.append(loss)
            norms.append(gnorm)
        # the last batch once more: the loss must not rise
        before = float(loss)
        state, m = step(state, batch)
        again = float(m["loss"])
        norms.append(m["grad_norm"])

        # one step under the profiler, its optimizer labelled
        batch = next(loader)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            with record_function("forward_backward"):
                loss, grads = zoo.loss_and_grads(state.params, cfg, batch)
            with record_function("optimizer"):
                adamw.apply(adamw.AdamWConfig(), grads, state.opt,
                            state.params)
            del grads
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t1) * 1e3
        losses.append(loss)
        busy = device_busy(prof, prof_ms, steps=1)
        busy["optimizer_device_ms"] = annotation_device_ms(prof, "optimizer")
        if busy.get("device_busy_ms") and busy["optimizer_device_ms"]:
            busy["optimizer_share"] = (busy["optimizer_device_ms"]
                                       / busy["device_busy_ms"])
    finally:
        loader.close()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(x) for x in losses]
    norms = [float(x) for x in norms]
    tokens = B * S
    flops = qwen_train_flops(cfg, n_params, tokens, S)
    fb_ms, opt_ms = sum(fb) / len(fb), sum(opt) / len(opt)
    emit("lm_train_qwen3_4b", card=card, arch=cfg.name,
         layers=cfg.num_layers, d_model=cfg.d_model, heads=cfg.num_heads,
         kv_heads=cfg.num_kv_heads, head_dim=cfg.hd, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, params=n_params, batch=B, seq=S,
         init_s=init_s, param_bytes=param_bytes, opt_bytes=opt_bytes,
         grad_bytes=param_bytes,
         state_and_grad_bytes=2 * param_bytes + opt_bytes,
         reckoned_bytes=QWEN_STATE_RECKONED, peak_bytes=peak,
         steps_timed=QWEN_TRAIN_TIMED, ms_per_step=step_ms,
         wall_ms_per_step=wall_s * 1e3, tokens_per_s=tokens / step_ms * 1e3,
         forward_backward_ms=fb_ms, optimizer_ms=opt_ms,
         optimizer_share=opt_ms / (fb_ms + opt_ms),
         model_flops=flops, recompute_excluded=True,
         bound_ms=flops / BF16_FLOPS * 1e3,
         mfu=flops / (step_ms / 1e3) / BF16_FLOPS,
         losses=losses, grad_norms=norms, repeat_batch_loss=before,
         repeat_loss=again, profile=busy)
    del params, state, loss, m, batch
    torch.cuda.empty_cache()
    if n_params != QWEN_PARAMS:
        raise AssertionError(f"qwen3-4b has {n_params} parameters")
    if not all(math.isfinite(x) for x in losses + norms + [again]):
        raise AssertionError(f"qwen3-4b training: non-finite {losses} {norms}")
    if again > before + LM_TWO_STEP_RISE:
        raise AssertionError(f"qwen3-4b: the last batch's loss rose from "
                             f"{before} to {again}")
    return losses


def annotation_device_ms(prof, name: str) -> float | None:
    """The device time a ``record_function(name)`` range spans on the card
    (the profiler's device-side user annotation), or None when the trace
    has none."""
    from torch.autograd import DeviceType

    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.name == name and e.device_type == DeviceType.CUDA]
    return sum(spans) / 1e3 if spans else None


def lm_train_launcher_phase(card: str) -> None:
    """Phase 24: ``launch.train --workload lm`` on cuda:0 for qwen3-4b and
    mamba2-130m (20 steps at smoke width), then the LM examples on cuda:0:
    ``torch_train_lm.py`` for LM_EXAMPLE_STEPS steps and
    ``torch_serve_lm.py`` at its defaults."""
    import contextlib
    import io
    import math

    from repro_torch.launch import train

    runs = []
    for arch in ("qwen3-4b", "mamba2-130m"):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(["--workload", "lm", "--arch", arch, "--iters",
                             "20"])
        out = buf.getvalue()
        losses = [float(ln.split("loss ")[1]) for ln in out.splitlines()
                  if ln.startswith("step ")]
        done = [ln for ln in out.splitlines() if ln.startswith("[done]")]
        runs.append(dict(arch=arch, rc=rc, losses=losses,
                         done=done[-1] if done else None,
                         wall_s=time.perf_counter() - t0))
    sys.path.insert(0, str(ROOT / "examples"))
    import torch_serve_lm
    import torch_train_lm

    t0 = time.perf_counter()
    ex = torch_train_lm.main(["--steps", str(LM_EXAMPLE_STEPS)])
    ex_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = torch_serve_lm.main([])
    serve_s = time.perf_counter() - t0
    first, last = sum(ex[:5]) / 5, sum(ex[-5:]) / 5
    emit("lm_train_launcher", card=card, runs=runs,
         example=dict(steps=len(ex), seconds=ex_s, first5_loss=first,
                      last5_loss=last, losses=ex),
         serve_example=dict(seconds=serve_s, device=served["device"],
                            position=served["position"],
                            finite=served["finite"],
                            decode_tokens_per_s=served[
                                "decode_tokens_per_s"]))
    for r in runs:
        if (r["rc"] != 0 or len(r["losses"]) != 2
                or not all(math.isfinite(x) for x in r["losses"])
                or not r["done"] or " on cuda" not in r["done"]):
            raise AssertionError(f"launcher --workload lm: {r}")
    if not (all(math.isfinite(x) for x in ex) and last < first):
        raise AssertionError(f"the training example's loss did not fall: "
                             f"{first} -> {last}")
    if not (served["device"].startswith("cuda") and served["finite"]
            and served["position"] == 64):
        raise AssertionError(f"the serving example: {served}")


def mesh_arch_vs_card(name: str, mesh, dev) -> dict:
    """Phase 25 for one architecture at its smoke() width: float32 (TF32
    off), weights and a batch drawn on the CPU from a seed, LM_TRAIN_STEPS
    mesh train steps (this rank's shards, gathered back after each step)
    against as many one-device steps on ``dev`` from the same state and
    batch (``train_steps``)."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs.archs import smoke
    from repro_torch.launch.specs import make_policy
    from repro_torch.models import convert, parallel, zoo
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_map
    from repro_torch.optim import adamw

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(smoke(name), dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    params = tf.init_params(cfg, gen)
    B, S = LM_TRAIN_B, LM_TRAIN_S
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen),
             "labels": torch.randint(0, cfg.vocab_size, (B, S),
                                     generator=gen)}
    if cfg.encoder_layers:
        batch["frames"] = torch.randn(B, cfg.encoder_frames, cfg.d_model,
                                      generator=gen)
    if cfg.vision_tokens:
        batch["patches"] = torch.randn(B, cfg.vision_tokens, cfg.d_model,
                                       generator=gen)
    one = train_steps(cfg, params, batch, dev, LM_TRAIN_STEPS)
    policy = make_policy(mesh, B)
    specs = tf.param_specs(cfg, policy)
    on_dev = {k: v.to(dev) for k, v in batch.items()}
    p_dev = tree_map(lambda a: a.to(dev, copy=True), params)
    state = convert.shard_train_state(
        zoo.TrainState(p_dev, adamw.init(p_dev)), specs, mesh,
        torch.distributed.get_rank())
    local = parallel.dp_rows(on_dev, policy.ctx)
    step = zoo.make_train_step(cfg, policy=policy)
    loss_err = norm_err = state_err = 0.0
    excess, steps_equal, finite = -math.inf, True, True
    for i, (ol, on, os_) in enumerate(one, 1):
        state, m = step(state, local)
        ml, mn = float(m["loss"]), float(m["grad_norm"])
        finite &= math.isfinite(ml) and math.isfinite(mn)
        loss_err = max(loss_err, abs(ml - ol) / abs(ol))
        norm_err = max(norm_err, abs(mn - on) / on)
        bound = sum(2 * lr_at(t) for t in range(1, i + 1)) + LM_STATE_ATOL
        got = convert.flatten(convert.gather_train_state(state, specs, mesh))
        for k, a in os_.items():
            if k == "opt.step":
                steps_equal &= int(got[k]) == int(a) == i
                continue
            e = float((got[k].to("cpu", torch.float64) - a).abs().max())
            state_err = max(state_err, e)
            excess = max(excess, e - bound)
    return dict(arch=name, loss_rel_err=loss_err, grad_norm_rel_err=norm_err,
                state_max_abs_err=state_err, state_within_bound=excess <= 0,
                steps_equal=steps_equal, finite=finite)


def mesh_step_nccl_ms(prof, name: str = "") -> float | None:
    """The device time of a profiled window's NCCL kernels (those whose
    name holds ``name`` when given: "SendRecv" is the all-to-all), or None
    when the trace holds no device time.  Only the kernels: c10d's GPU
    annotation around each one ("nccl:all_reduce") spans the same time and
    would count it twice."""
    from torch.autograd import DeviceType

    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and "nccl" in e.name.lower() and "kernel" in e.name.lower()
          and name in e.name]
    if not any(e.device_type == DeviceType.CUDA for e in prof.events()):
        return None
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3


NCCL_KINDS = ("AllGather", "ReduceScatter", "AllReduce", "SendRecv")


def nccl_kinds_ms(prof) -> dict:
    """``mesh_step_nccl_ms`` of each kind of NCCL kernel (NCCL_KINDS)."""
    return {k: mesh_step_nccl_ms(prof, k) for k in NCCL_KINDS}


def moe_config(layers: int):
    """``MOE_ARCH`` at its published widths, cut to ``layers`` layers."""
    import dataclasses

    from repro_torch.configs.archs import ARCHS

    return dataclasses.replace(ARCHS[MOE_ARCH], num_layers=layers)


@contextlib.contextmanager
def counting_routes():
    """``moe.route`` wrapped to add up, on the device, the (token, k)
    routings it makes and those it keeps: yields [kept, made] (tensors
    once a route ran; no host sync)."""
    from repro_torch.models import moe

    real, tally = moe.route, [0, 0]

    def route(*args):
        r = real(*args)
        tally[0] = tally[0] + r.keep.sum()
        tally[1] = tally[1] + r.keep.numel()
        return r

    moe.route = route
    try:
        yield tally
    finally:
        moe.route = real


def qwen_mesh_steps(mesh, batch: int, steps: int, dev,
                    profiled: bool = False, cfg=None) -> dict:
    """qwen3-4b at full width (or ``cfg``) over ``mesh`` on this rank:
    this rank's shards drawn from the seed (``init_params`` under the
    policy), ``steps`` mesh train steps on ``lm_batches(vocab, batch,
    4096)`` (this rank's dp rows), the first a warm-up and the rest between
    CUDA events; this card's peak bytes; then one more step on every rank
    (its collectives need them all), under ``torch.profiler`` where
    ``profiled`` (busy share, NCCL kernel time, the all-to-all's apart).
    An MoE config also counts the routings its capacity drops in the
    warm-up step, and its ``mfu`` counts the reference's model FLOPs
    (active parameters).  Everything is freed at the end."""
    import contextlib

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.archs import QWEN3_4B
    from repro_torch.data.loader import PrefetchLoader, lm_batches
    from repro_torch.launch import roofline
    from repro_torch.launch.specs import make_policy, meta_params
    from repro_torch.models import parallel, zoo
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw

    cfg = cfg or QWEN3_4B
    world = dist.get_world_size()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    policy = make_policy(mesh, batch)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        SEED), policy=policy)
    torch.cuda.empty_cache()          # the whole model drawn, then freed
    state = zoo.TrainState(params, adamw.init(params))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    nbytes = lambda tree: sum(a.numel() * a.element_size()  # noqa: E731
                              for a in tree_leaves(tree))
    local_bytes = 2 * nbytes(params) + nbytes(state.opt)
    S = QWEN_TRAIN_S
    step = zoo.make_train_step(cfg, policy=policy)
    loader = PrefetchLoader(lm_batches(cfg.vocab_size, batch, S, seed=SEED),
                            device=dev)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    losses, norms, busy = [], [], None
    try:
        with counting_routes() as routes:
            state, m = step(state, parallel.dp_rows(next(loader),
                                                    policy.ctx))
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        a, b = ev(), ev()
        a.record()
        for _ in range(steps - 1):
            state, m = step(state, parallel.dp_rows(next(loader),
                                                    policy.ctx))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        b.record()
        b.synchronize()
        step_ms = a.elapsed_time(b) / (steps - 1)
        batch_ = parallel.dp_rows(next(loader), policy.ctx)
        torch.cuda.synchronize()
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) if profiled
               else contextlib.nullcontext())
        with ctx as prof:
            t1 = time.perf_counter()
            state, m = step(state, batch_)
            torch.cuda.synchronize()
            prof_ms = (time.perf_counter() - t1) * 1e3
        if profiled:
            busy = device_busy(prof, prof_ms, steps=1)
            busy["nccl_device_ms"] = mesh_step_nccl_ms(prof)
            busy["nccl_all_to_all_device_ms"] = mesh_step_nccl_ms(
                prof, "SendRecv")
            busy["nccl_by_kind_ms"] = nccl_kinds_ms(prof)
    finally:
        loader.close()
    peak = torch.cuda.max_memory_allocated(dev)
    tokens = batch * S
    n_params = sum(a.numel() for a in tree_leaves(meta_params(cfg)))
    ref_flops = roofline.step_flops(cfg, "train", batch, S)
    flops = ref_flops if cfg.is_moe else qwen_train_flops(
        cfg, n_params, tokens, S)
    out = dict(arch=cfg.name, layers=cfg.num_layers, params=n_params,
               mesh=list(mesh.mesh.shape), ranks=world, batch=batch, seq=S,
               dp=list(policy.dp), tp=policy.ctx.tp_size,
               sp=policy.with_sequence(S).seq, init_s=init_s,
               local_state_and_grad_bytes=local_bytes,
               reckoned_bytes_per_card=(STATE_BYTES_PER_PARAM * n_params
                                        / world),
               peak_bytes=peak, steps=steps, ms_per_step=step_ms,
               tokens_per_s=tokens / step_ms * 1e3, model_flops=flops,
               mfu=flops / (step_ms / 1e3) / (world * BF16_FLOPS),
               reference_model_flops=ref_flops,
               mfu_reference_count=ref_flops / (step_ms / 1e3)
               / (world * BF16_FLOPS),
               losses=[float(x) for x in losses],
               grad_norms=[float(x) for x in norms], profile=busy)
    if cfg.is_moe:
        out["dropped_share"] = 1 - float(routes[0]) / routes[1]
    del params, state, m
    torch.cuda.empty_cache()
    return out


def lm_mesh_phase(card: str, first_losses: list) -> list | None:
    """Phase 25 on one card: a one-rank NCCL group and a (1, 1) mesh (see
    the module docstring), then the MoE at full width cut to
    MOE_LAYERS_ONE layers; then, with four cards, ``lm_mesh_four``, whose
    rows it returns."""
    import math
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch.mesh import make_production_mesh

    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_production_mesh(1)
            rows = [mesh_arch_vs_card(n, mesh, dev) for n in ARCHS]
            arch_s = time.perf_counter() - t0
            qwen = qwen_mesh_steps(mesh, QWEN_TRAIN_B, MESH_LM_STEPS, dev)
            t1 = time.perf_counter()
            moe = qwen_mesh_steps(mesh, QWEN_TRAIN_B, MESH_LM_STEPS, dev,
                                  profiled=True,
                                  cfg=moe_config(MOE_LAYERS_ONE))
            moe["seconds"] = time.perf_counter() - t1
        finally:
            dist.destroy_process_group()
    want = first_losses[:MESH_LM_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(qwen["losses"], want))
    emit("lm_mesh", card=card, archs=rows, archs_s=arch_s, qwen3_4b=qwen,
         phase23_losses=want, loss_rel_err_vs_phase23=rel, moe=moe,
         seconds=time.perf_counter() - t0)
    for r in rows:
        if (r["loss_rel_err"] > LM_LOSS_REL or r["grad_norm_rel_err"] >
                LM_NORM_REL or not r["state_within_bound"]
                or not r["steps_equal"] or not r["finite"]):
            raise AssertionError(f"{r['arch']} over a mesh: {r}")
    if not all(math.isfinite(x) for x in qwen["losses"] + qwen["grad_norms"]):
        raise AssertionError(f"qwen3-4b over a mesh: {qwen['losses']}")
    if rel > LM_LOSS_REL:
        raise AssertionError(f"qwen3-4b on a (1, 1) mesh: losses "
                             f"{qwen['losses']} against phase 23's {want}")
    if not all(math.isfinite(x) for x in moe["losses"] + moe["grad_norms"]):
        raise AssertionError(f"{MOE_ARCH} over a mesh: {moe['losses']}")
    if torch.cuda.device_count() >= 4:
        return lm_mesh_four(card, qwen["losses"])
    return None


def _lm_mesh_rank(rank: int, layout: str, batch: int, out_dir: str,
                  moe_layers: int = 0) -> None:
    """One of ``lm_mesh_four``'s NCCL ranks: ``qwen_mesh_steps`` on card
    ``rank`` over the ``layout`` of MESH_LM_FOUR (qwen3-4b, or the MoE cut
    to ``moe_layers`` layers), its row written to ``out_dir``."""
    import torch

    from repro_torch.distributed.launch import training_mesh
    from repro_torch.launch.mesh import make_production_mesh

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = (make_production_mesh(4) if layout == "production"
            else training_mesh("cuda", "2d"))
    row = qwen_mesh_steps(mesh, batch, MESH_LM_STEPS, dev,
                          profiled=rank == 0,
                          cfg=moe_config(moe_layers) if moe_layers else None)
    row["device"] = torch.cuda.get_device_name(dev)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(row))


def lm_mesh_four(card: str, one_card_losses: list | None,
                 configs=MESH_LM_FOUR, rank_fn=None,
                 moe_layers: int = 0) -> list:
    """Phase 25 on four cards: for each (layout, B) of ``configs``, 4
    spawned NCCL ranks train qwen3-4b at full width (or the MoE cut to
    ``moe_layers`` layers; ``_lm_mesh_rank``); one line a configuration
    with every card's peak bytes and, at B = 1 with ``one_card_losses``
    given, the losses' largest relative difference from them (the same
    batches on one card, bf16 summed in another order), which must stay
    within MESH_FOUR_LOSS_REL.  ``rank_fn`` (``_lm_mesh_rank`` unless
    given) runs each rank."""
    import math
    import tempfile

    from repro_torch.distributed import launch

    out = []
    for layout, batch in configs:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            launch.spawn(rank_fn or _lm_mesh_rank, 4,
                         args=(layout, batch, tmp, moe_layers),
                         device_type="cuda", store_dir=tmp,
                         timeout_s=MESH_COLLECTIVE_TIMEOUT_S)
            ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                     for r in range(4)]
        lead = ranks[0]
        row = dict(lead, layout=layout,
                   peak_bytes_per_card=[r["peak_bytes"] for r in ranks],
                   ms_per_step_per_rank=[r["ms_per_step"] for r in ranks],
                   seconds=time.perf_counter() - t0)
        row.pop("peak_bytes")
        if "dropped_share" in lead:
            row["dropped_share_per_rank"] = [r["dropped_share"]
                                             for r in ranks]
        if batch == 1 and one_card_losses:
            row["loss_rel_diff_vs_one_card"] = max(
                abs(a - b) / abs(b)
                for a, b in zip(lead["losses"], one_card_losses))
        emit("lm_mesh_four", card=card, **row)
        out.append(row)
        where = f"{lead['arch']} on a {lead['mesh']} mesh at B = {batch}"
        if not all(math.isfinite(x) for r in ranks
                   for x in r["losses"] + r["grad_norms"]):
            raise AssertionError(f"{where}: non-finite losses")
        if row.get("loss_rel_diff_vs_one_card", 0.0) > MESH_FOUR_LOSS_REL:
            raise AssertionError(f"{where}: losses {lead['losses']} against "
                                 f"one card's {one_card_losses}")
    return out


def lm_train_timed(cfg, B: int, S: int, warm: int, timed: int, dev,
                   seed: int = SEED, micro_batches: int = 1) -> dict:
    """One-device training of ``cfg`` on ``dev`` from weights drawn from
    ``seed`` (params of the config's dtype, float32 AdamW state) on
    ``lm_batches(vocab, B, S)``: ``warm`` steps, then ``timed`` steps
    between CUDA events; ms a step, tokens/s, the reference's model FLOPs
    (``roofline.step_flops``: 6 N T, N the active parameters without
    norms, plus the attention's causal half) over 989 TFLOP/s (``mfu``),
    the peak bytes and every step's loss and grad norm (``micro_batches``:
    each step's gradient summed over that many micro-batches).
    Everything is freed at the end."""
    import torch

    from repro_torch.data.loader import PrefetchLoader, lm_batches
    from repro_torch.launch import roofline
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import adamw

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(
        seed))
    n_params = sum(a.numel() for a in tree_leaves(params))
    state = zoo.TrainState(params, adamw.init(params))
    step = zoo.make_train_step(cfg, micro_batches=micro_batches)
    loader = PrefetchLoader(lm_batches(cfg.vocab_size, B, S, seed=seed),
                            device=dev)
    losses, norms = [], []
    try:
        for _ in range(warm):
            state, m = step(state, next(loader))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(timed):
            state, m = step(state, next(loader))
            losses.append(m["loss"])
            norms.append(m["grad_norm"])
        b.record()
        b.synchronize()
    finally:
        loader.close()
    ms = a.elapsed_time(b) / timed
    flops = roofline.step_flops(cfg, "train", B, S)
    out = dict(arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
               params=n_params, batch=B, seq=S, steps_timed=timed,
               ms_per_step=ms, tokens_per_s=B * S / ms * 1e3,
               reference_model_flops=flops,
               mfu_reference_count=flops / (ms / 1e3) / BF16_FLOPS,
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               losses=[float(x) for x in losses],
               grad_norms=[float(x) for x in norms])
    del params, state, m
    torch.cuda.empty_cache()
    return out


def mamba_phase(card: str, dev="cuda:0") -> list:
    """Phase 27: mamba2-130m at full width on the card (see the module
    docstring); everything is freed at the end.  Returns the training
    losses, in the order of the batches."""
    import dataclasses
    import math

    import torch

    from repro_torch.configs.archs import ARCHS
    from repro_torch.launch import roofline
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.common import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ARCHS[MAMBA_ARCH]
    dev = torch.device(dev)
    V = cfg.vocab_size
    t0 = time.perf_counter()
    train = lm_train_timed(cfg, MAMBA_TRAIN_B, MAMBA_TRAIN_S, MAMBA_WARM,
                           MAMBA_TIMED, dev)
    train_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tf.init_params(cfg, gen)
    w_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(params))
    # float32 (TF32 off): a prompt decoded token by token == its prefill
    c32 = dataclasses.replace(cfg, dtype=torch.float32)
    prompt = torch.randint(0, V, (2, MAMBA_PROMPT), generator=gen,
                           device=dev)
    f32_rel = decode_vs_prefill(c32, tree_map(lambda a: a.float(), params),
                                prompt, dev, 2 * MAMBA_PROMPT)
    torch.cuda.empty_cache()
    # a prefill of MAMBA_PREFILL_S tokens at B = 1
    prefill = zoo.make_prefill_step(cfg)
    toks = torch.randint(0, V, (1, MAMBA_PREFILL_S), generator=gen,
                         device=dev)
    pre = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(MAMBA_PREFILL_CALLS):
        pre = prefill(params, {"tokens": toks})
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t1) / MAMBA_PREFILL_CALLS * 1e3
    pre_flops = roofline.step_flops(cfg, "prefill", 1, MAMBA_PREFILL_S)
    # greedy bf16 decode at MAMBA_DECODE_B from a stand-in state
    B = MAMBA_DECODE_B
    step = zoo.make_decode_step(cfg)
    st = zoo.init_decode_state(cfg, B, MAMBA_PROMPT, generator=gen)
    h_bytes = sum(a.numel() * a.element_size() for a in tree_leaves(st)
                  if a.is_floating_point())
    tok = torch.randint(0, V, (B, 1), generator=gen, device=dev)
    for _ in range(2):                                       # warm-up
        logits, st = step(params, st, tok)
        tok = logits[..., :V].argmax(-1)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(MAMBA_DECODE_STEPS):
        logits, st = step(params, st, tok)
        tok = logits[..., :V].argmax(-1)
    b.record()
    b.synchronize()
    dec_ms = a.elapsed_time(b) / MAMBA_DECODE_STEPS
    losses = train["losses"]
    decode = dict(batch=B, steps=MAMBA_DECODE_STEPS, ms_per_step=dec_ms,
                  tokens_per_s=B / dec_ms * 1e3, weight_bytes=w_bytes,
                  state_bytes=h_bytes,
                  # the weights read once, the state read and written
                  bound_ms=(w_bytes + 2 * h_bytes) / HBM_BYTES_PER_S * 1e3,
                  position=int(st.position),
                  finite=bool(torch.isfinite(logits.float()).all()))
    emit("lm_mamba2_130m", card=card, train=train, train_s=train_s,
         f32_decode_vs_prefill_rel_err=f32_rel, f32_prompt=MAMBA_PROMPT,
         prefill=dict(batch=1, S=MAMBA_PREFILL_S, ms=pre_ms,
                      tokens_per_s=MAMBA_PREFILL_S / pre_ms * 1e3,
                      reference_model_flops=pre_flops,
                      bound_ms=pre_flops / BF16_FLOPS * 1e3,
                      finite=bool(torch.isfinite(pre.float()).all())),
         decode=decode, serve_peak_bytes=torch.cuda.max_memory_allocated(dev),
         seconds=time.perf_counter() - t0)
    del params, st, logits, pre, prompt, toks
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in losses + train["grad_norms"]):
        raise AssertionError(f"{MAMBA_ARCH} training: non-finite {losses}")
    if not min(losses[-3:]) < losses[0]:
        raise AssertionError(f"{MAMBA_ARCH}: the loss did not fall: "
                             f"{losses}")
    if f32_rel > QWEN_F32_REL:
        raise AssertionError(f"{MAMBA_ARCH} float32 decode vs prefill "
                             f"{f32_rel}")
    if not (decode["finite"] and decode["position"] == 2 +
            MAMBA_DECODE_STEPS):
        raise AssertionError(f"{MAMBA_ARCH} decode: {decode}")
    return losses


def lm_serve_mesh_phase(card: str, dev="cuda:0") -> list | None:
    """Phase 26 on one card (see the module docstring): a one-rank NCCL
    group's (1, 1) mesh against the one-device steps, bit for bit
    (``serve_mesh_one``); then, with four cards, ``lm_serve_four``, whose
    rows it returns."""
    import torch

    serve_mesh_one(card, dev)
    torch.cuda.empty_cache()         # cuda:0 is rank 0's in the spawns
    if torch.cuda.device_count() >= 4:
        return lm_serve_four(card, dev=str(dev))
    return None


def serve_mesh_one(card: str, dev) -> None:
    """Phase 26's (1, 1) mesh on ``dev``; every tensor it makes is freed
    when it returns."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.configs.archs import QWEN3_4B as cfg
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import make_policy
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo
    from repro_torch.models.convert import flatten

    dev = torch.device(dev)
    V = cfg.vocab_size
    t0 = time.perf_counter()
    torch.empty(1, device=dev)       # memory stats need the allocator
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731

    def same(a, b) -> bool:
        fa, fb = flatten(a), flatten(b)
        return sorted(fa) == sorted(fb) and all(
            fa[k].shape == fb[k].shape and torch.equal(fa[k], fb[k])
            for k in fa)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_production_mesh(1)
            params = tf.init_params(cfg, torch.Generator(
                device=dev).manual_seed(SEED))
            local = tf.init_params(cfg, torch.Generator(
                device=dev).manual_seed(SEED),
                policy=make_policy(mesh, QWEN_BATCHES[0], "decode"))
            init_equal = same(params, local)
            rows = []
            for B in QWEN_BATCHES:
                policy = make_policy(mesh, B, "decode")
                one = zoo.init_decode_state(
                    cfg, B, QWEN_MAX, QWEN_PREFILL,
                    generator=torch.Generator(device=dev).manual_seed(B))
                mine = zoo.init_decode_state(
                    cfg, B, QWEN_MAX, QWEN_PREFILL,
                    generator=torch.Generator(device=dev).manual_seed(B),
                    policy=policy)
                state_equal = same(one, mine)
                tok = torch.randint(0, V, (B, MESH_SERVE_STEPS), device=dev,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(B + 1))
                ms, logits, after = {}, {}, {}
                for name, p, st, step in (
                        ("one", params, one, zoo.make_decode_step(cfg)),
                        ("mesh", local, mine, zoo.make_decode_step(
                            cfg, policy=policy))):
                    a, b = ev(), ev()
                    a.record()
                    outs = []
                    for i in range(MESH_SERVE_STEPS):
                        out, st = step(p, st, tok[:, i:i + 1])
                        outs.append(out)
                    b.record()
                    b.synchronize()
                    ms[name] = a.elapsed_time(b) / MESH_SERVE_STEPS
                    logits[name], after[name] = outs, st
                rows.append(dict(
                    batch=B, steps=MESH_SERVE_STEPS, state_equal=state_equal,
                    bit_equal=all(torch.equal(x, y) for x, y in
                                  zip(logits["one"], logits["mesh"])),
                    same_state_after=same(after["one"], after["mesh"]),
                    position=int(after["mesh"].position),
                    finite=bool(torch.isfinite(
                        logits["mesh"][-1].float()).all()),
                    ms_per_step_one_device=ms["one"],
                    ms_per_step_mesh=ms["mesh"]))
                del one, mine, logits, after
                torch.cuda.empty_cache()
            toks = torch.randint(0, V, (1, QWEN_S), device=dev,
                                 generator=torch.Generator(
                                     device=dev).manual_seed(2))
            pre = {}
            for name, p, step in (
                    ("one", params, zoo.make_prefill_step(cfg)),
                    ("mesh", local, zoo.make_prefill_step(
                        cfg, policy=make_policy(mesh, 1, "prefill")))):
                a, b = ev(), ev()
                a.record()
                pre[name] = step(p, {"tokens": toks})
                b.record()
                b.synchronize()
                pre[name + "_ms"] = a.elapsed_time(b)
        finally:
            dist.destroy_process_group()
    prefill = dict(S=QWEN_S, bit_equal=torch.equal(pre["one"], pre["mesh"]),
                   finite=bool(torch.isfinite(pre["mesh"].float()).all()),
                   ms_one_device=pre["one_ms"], ms_mesh=pre["mesh_ms"])
    peak = torch.cuda.max_memory_allocated(dev)
    del params, local, pre
    torch.cuda.empty_cache()
    emit("lm_serve_mesh", card=card, arch=cfg.name, mesh=[1, 1],
         init_equal=init_equal, decode=rows, prefill=prefill,
         peak_bytes=peak, seconds=time.perf_counter() - t0)
    if not init_equal:
        raise AssertionError("qwen3-4b: init_params(policy=) differs from "
                             "the whole draw")
    for r in rows:
        if not (r["state_equal"] and r["bit_equal"] and r["same_state_after"]
                and r["finite"] and r["position"] ==
                QWEN_PREFILL + MESH_SERVE_STEPS):
            raise AssertionError(f"qwen3-4b decode on a (1, 1) mesh: {r}")
    if not (prefill["bit_equal"] and prefill["finite"]):
        raise AssertionError(f"qwen3-4b prefill on a (1, 1) mesh: {prefill}")


@contextlib.contextmanager
def counting_collectives():
    """The collectives ``models/parallel.py`` issues, wrapped to add up the
    bytes of their results by op: yields {op: bytes}."""
    import torch.distributed as dist

    tally: dict = {}
    names = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "all_to_all_single")
    real = {n: getattr(dist, n) for n in names}

    def wrap(n):
        def call(out, *args, **kw):
            tally[n] = tally.get(n, 0) + out.numel() * out.element_size()
            return real[n](out, *args, **kw)
        return call

    for n in names:
        setattr(dist, n, wrap(n))
    try:
        yield tally
    finally:
        for n in names:
            setattr(dist, n, real[n])


def _scale_kv(state) -> None:
    """Every KV cache's keys of ``state`` times SERVE_GATE_KV_SCALE and
    its values times SERVE_GATE_V_SCALE, in place (the same elementwise
    bf16 product on a whole state and on a shard of it)."""
    from repro_torch.models.convert import flatten

    for k, a in flatten(state).items():
        if k.endswith(".k"):
            a.mul_(SERVE_GATE_KV_SCALE)
        elif k.endswith(".v"):
            a.mul_(SERVE_GATE_V_SCALE)


def _gate_config(job: str):
    """(config, B, cache slots, steps) of a job's gate."""
    from repro_torch.configs.archs import GEMMA2_27B, QWEN3_4B

    return ((QWEN3_4B,) + SERVE_GATE_QWEN if job == "qwen"
            else (GEMMA2_27B,) + SERVE_GATE_GEMMA)


def _gate_tokens(cfg, B: int, steps: int):
    import torch

    return torch.randint(0, cfg.vocab_size, (B, steps),
                         generator=torch.Generator().manual_seed(SEED + 3))


def serve_gate_reference(job: str, dev, path: str) -> None:
    """The one-card side of a four-card gate: the whole model and stand-in
    state drawn from the seed on ``dev``, the caches scaled
    (``_scale_kv``), ``steps`` decode steps on ``_gate_tokens``; their
    logits (the real vocabulary, float32, on the host) saved to ``path``.
    Everything is freed at the end."""
    import torch

    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo

    cfg, B, slots, steps = _gate_config(job)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tf.init_params(cfg, gen)
    state = zoo.init_decode_state(cfg, B, slots, slots - 1, generator=gen)
    _scale_kv(state)
    tokens = _gate_tokens(cfg, B, steps).to(dev)
    step = zoo.make_decode_step(cfg)
    out = []
    for i in range(steps):
        logits, state = step(params, state, tokens[:, i:i + 1])
        out.append(logits[..., :cfg.vocab_size].float().cpu())
    torch.save(torch.stack(out), path)
    del params, state, logits
    torch.cuda.empty_cache()


@contextlib.contextmanager
def planted_serve_fault(job: str):
    """The fault each gate must catch.  qwen3-4b on (1, 4) (layout (a),
    no slot shard): tp rank 1's attention output is left out of ``wo``'s
    all-reduce (it sends zeros).  gemma2-27b on (2, 2) (layout (c)): the
    slot shard at data coordinate 1 is left out of the softmax's combine
    (its scores all masked, so its partial sums are zero)."""
    import torch

    from repro_torch.models import attention as attn_lib
    from repro_torch.models import parallel

    if job == "qwen":
        real = parallel.reduce_out

        def reduce_out(x, ctx, axes=None):
            if sys._getframe(1).f_code.co_name == "_mesh_decode_attention" \
                    and ctx.tp_rank == 1:
                x = x * 0
            return real(x, ctx, axes)

        parallel.reduce_out = reduce_out
        try:
            yield
        finally:
            parallel.reduce_out = real
        return
    real = attn_lib._combine_slots

    def combine(logits, v, axes, ctx, dtype):
        if ctx.coord.get("data") == 1:
            logits = torch.full_like(logits, attn_lib.NEG_INF)
        return real(logits, v, axes, ctx, dtype)

    attn_lib._combine_slots = combine
    try:
        yield
    finally:
        attn_lib._combine_slots = real


def _gate_run(cfg, params, state, tokens, policy, ref) -> float:
    """Decode ``tokens`` from a copy of ``state`` on the mesh: the largest
    difference of the gathered logits from ``ref`` over its scale."""
    from repro_torch.models import parallel, zoo
    from repro_torch.models.common import P, tree_map

    st = tree_map(lambda a: a.clone(), state)
    step = zoo.make_decode_step(cfg, policy=policy)
    spec = P(policy.batch(), None, policy.tp)
    err = 0.0
    for i in range(tokens.shape[1]):
        logits, st = step(params, st, tokens[:, i:i + 1])
        full = parallel.gather_full(logits, spec, policy.ctx)
        got = full[..., :cfg.vocab_size].float().cpu()
        err = max(err, float((got - ref[i]).abs().max() / ref[i].abs().max()))
    return err


def serve_run(cfg, params, mesh, B: int, slots: int, steps: int,
              dev) -> dict:
    """``steps`` timed decode steps of ``cfg`` over ``mesh`` on this rank:
    its shards of a stand-in state of ``slots`` slots holding ``slots -
    1`` tokens drawn under the policy, tokens from a seeded generator (the
    same on every rank), 2 warm-up steps first; then one step with its
    collectives counted and one under ``torch.profiler`` (every rank runs
    both: their collectives need them all).  ``peak_bytes`` is the
    decoding's, from after the state's draw (``init_peak_bytes``, whose
    transients hold one layer's whole cache).  Everything is freed."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.specs import make_policy
    from repro_torch.models import parallel, zoo
    from repro_torch.models.common import tree_leaves

    policy = make_policy(mesh, B, "decode")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = zoo.init_decode_state(
        cfg, B, slots, slots - 1, policy=policy,
        generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    tokens = parallel.dp_rows({"t": torch.randint(
        0, cfg.vocab_size, (B, steps + 4),
        generator=torch.Generator().manual_seed(SEED + 2))},
        policy.ctx)["t"].to(dev)
    step = zoo.make_decode_step(cfg, policy=policy)
    for i in range(2):
        logits, state = step(params, state, tokens[:, i:i + 1])
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for i in range(2, 2 + steps):
        logits, state = step(params, state, tokens[:, i:i + 1])
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b) / steps
    with counting_collectives() as nccl:
        logits, state = step(params, state, tokens[:, -2:-1])
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        logits, state = step(params, state, tokens[:, -1:])
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof, prof_ms, steps=1)
    busy["top_kernels"] = busy.get("top_kernels", [])[:5]
    busy["nccl_device_ms"] = mesh_step_nccl_ms(prof)
    w_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    kv = cache_bytes(state)
    out = dict(batch=B, slots=slots, steps=steps, init_s=init_s,
               init_peak_bytes=init_peak, ms_per_step=ms,
               tokens_per_s=B / ms * 1e3,
               weight_bytes=w_bytes, kv_cache_bytes=kv,
               bound_ms=(w_bytes + kv) / HBM_BYTES_PER_S * 1e3,
               nccl_bytes_per_step=nccl,
               act_share=sum(nccl.values()) / w_bytes,
               position=int(state.position), profile=busy,
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               finite=bool(torch.isfinite(logits.float()).all()))
    del state, logits
    torch.cuda.empty_cache()
    return out


def prefill_run(cfg, params, mesh, B: int, S: int, dev,
                sp: bool = True) -> dict:
    """A prefill of ``B`` x ``S`` seeded tokens over ``mesh`` on this rank
    (its rows), one warm-up call and one timed (CUDA events), then one
    under ``torch.profiler``; its FLOP bound over the ranks' 989 TFLOP/s
    (phase 20's dense count).  ``sp=False``: the policy's sequence
    parallelism off (the residual replicated over tp)."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.specs import make_policy, meta_params
    from repro_torch.models import parallel, zoo
    from repro_torch.models.common import padded_vocab, tree_leaves

    policy = dataclasses.replace(make_policy(mesh, B, "prefill"), sp=sp)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    toks = parallel.dp_rows({"tokens": torch.randint(
        0, cfg.vocab_size, (B, S),
        generator=torch.Generator().manual_seed(SEED + 4))},
        policy.ctx)["tokens"].to(dev)
    step = zoo.make_prefill_step(cfg, policy=policy)
    step(params, {"tokens": toks})
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    with counting_collectives() as nccl:
        logits = step(params, {"tokens": toks})
    b.record()
    b.synchronize()
    ms = a.elapsed_time(b)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(params, {"tokens": toks})
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t1) * 1e3
    busy = device_busy(prof, prof_ms, steps=1)
    busy["top_kernels"] = busy.get("top_kernels", [])[:5]
    busy["nccl_device_ms"] = mesh_step_nccl_ms(prof)
    busy["nccl_by_kind_ms"] = nccl_kinds_ms(prof)
    n_params = sum(t.numel() for t in tree_leaves(meta_params(cfg)))
    vp = padded_vocab(cfg.vocab_size)
    flops = B * (2 * (n_params - vp * cfg.d_model) * S
                 + 2 * cfg.d_model * vp
                 + 2 * S * S * cfg.num_heads * cfg.hd * cfg.num_layers)
    out = dict(batch=B, S=S, sp=policy.with_sequence(S).seq, ms=ms,
               tokens_per_s=B * S / ms * 1e3,
               flops=flops, bound_ms=flops / (dist.get_world_size()
                                              * BF16_FLOPS) * 1e3,
               nccl_bytes=nccl, profile=busy,
               peak_bytes=torch.cuda.max_memory_allocated(dev),
               finite=bool(torch.isfinite(logits.float()).all()))
    del logits
    torch.cuda.empty_cache()
    return out


def _serve_rank(rank: int, job: str, tmp: str) -> None:
    """One of ``lm_serve_four``'s NCCL ranks (``serve_job``).  A failure
    is printed at once: the group's teardown after it can wait on the
    peers until their collectives time out."""
    import traceback

    try:
        serve_job(rank, job, tmp)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        raise


def serve_job(rank: int, job: str, tmp: str) -> None:
    """The gate (clean, then with ``planted_serve_fault``) against
    ``serve_gate_reference``'s logits, then the runs of ``job`` (qwen3-4b's
    decode and prefill on (1, 4), or gemma2-27b's long_500k on (2, 2)) on
    this rank; its row written to ``tmp``."""
    import torch

    from repro_torch.distributed.launch import training_mesh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.specs import make_policy
    from repro_torch.models import parallel
    from repro_torch.models import transformer as tf
    from repro_torch.models import zoo

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = (make_production_mesh(4) if job == "qwen"
            else training_mesh("cuda", "2d"))
    cfg, B, slots, steps = _gate_config(job)
    policy = make_policy(mesh, B, "decode")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = tf.init_params(cfg, gen, policy=policy)
    torch.cuda.empty_cache()
    state = zoo.init_decode_state(cfg, B, slots, slots - 1, generator=gen,
                                  policy=policy)
    _scale_kv(state)
    tokens = parallel.dp_rows({"t": _gate_tokens(cfg, B, steps)},
                              policy.ctx)["t"].to(dev)
    ref = torch.load(Path(tmp, f"{job}_ref.pt"))
    clean = _gate_run(cfg, params, state, tokens, policy, ref)
    with planted_serve_fault(job):
        planted = _gate_run(cfg, params, state, tokens, policy, ref)
    del state
    torch.cuda.empty_cache()
    row = dict(rank=rank, device=torch.cuda.get_device_name(dev),
               arch=cfg.name, mesh=list(mesh.mesh.shape),
               dp=list(policy.dp), tp=policy.ctx.tp_size,
               gate=dict(batch=B, slots=slots, steps=steps, clean=clean,
                         planted=planted, bound=SERVE_GATE_REL,
                         seconds=time.perf_counter() - t0))
    if job == "qwen":
        Bd, sl, st = SERVE_FOUR_QWEN
        row["decode"] = serve_run(cfg, params, mesh, Bd, sl, st, dev)
        row["prefill"] = prefill_run(cfg, params, mesh, *SERVE_FOUR_PREFILL,
                                     dev)
        # the same prefill with the residual replicated over tp: the
        # same-call baseline of sequence parallelism
        row["prefill_replicated"] = prefill_run(
            cfg, params, mesh, *SERVE_FOUR_PREFILL, dev, sp=False)
    else:
        row["decode"] = serve_run(cfg, params, mesh, *SERVE_FOUR_GEMMA, dev)
    Path(tmp, f"{job}_rank{rank}.json").write_text(json.dumps(row))


def lm_serve_four(card: str, jobs=("qwen", "gemma"), rank_fn=None,
                  dev="cuda:0") -> list:
    """Phase 26 on four cards: for each job, the gate's one-card reference
    on ``dev`` (``serve_gate_reference``), then 4 spawned NCCL ranks
    (``_serve_rank``, unless ``rank_fn`` is given); one line a job with
    every rank's row.  Every job runs; then it fails unless every rank's
    logits are finite, the decode step's collectives are activation-sized,
    and the gate holds clean and catches its planted fault."""
    import tempfile

    import torch

    from repro_torch.distributed import launch

    out, failed = [], []
    for job in jobs:
        t0 = time.perf_counter()
        try:
            with tempfile.TemporaryDirectory() as tmp:
                serve_gate_reference(job, torch.device(dev),
                                     str(Path(tmp, f"{job}_ref.pt")))
                ref_s = time.perf_counter() - t0
                launch.spawn(rank_fn or _serve_rank, 4, args=(job, tmp),
                             device_type="cuda", store_dir=tmp,
                             timeout_s=SERVE_TIMEOUT_S)
                ranks = [json.loads(Path(tmp, f"{job}_rank{r}.json")
                                    .read_text()) for r in range(4)]
        except Exception as exc:  # noqa: BLE001 (the other job still runs)
            failed.append(f"{job}: {type(exc).__name__}: {exc}")
            torch.cuda.empty_cache()
            continue
        row = dict(job=job, arch=ranks[0]["arch"], mesh=ranks[0]["mesh"],
                   reference_s=ref_s, seconds=time.perf_counter() - t0,
                   ranks=ranks)
        emit("lm_serve_four", card=card, **row)
        out.append(row)
        where = f"{row['arch']} on a {row['mesh']} mesh"
        for r in ranks:
            g, d = r["gate"], r["decode"]
            if not g["clean"] <= SERVE_GATE_REL < g["planted"]:
                failed.append(f"{where}, rank {r['rank']}: gate {g}")
            failed += [f"{where}: non-finite {kind}"
                       for kind in ("decode", "prefill",
                                    "prefill_replicated")
                       if kind in r and not r[kind]["finite"]]
            if d["act_share"] > SERVE_ACT_SHARE:
                failed.append(f"{where}: a decode step's collectives "
                              f"{d['nccl_bytes_per_step']} are not "
                              "activation-sized")
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def train_phases(card: str, scale: float, iters: int,
                 device="cuda:0") -> list[dict]:
    """Phases 7-15; returns the kernels-line rows of K1, K2, K4 and the
    ELL kernel."""
    import numpy as np
    import torch

    from repro_torch.configs import lda_nytimes
    from repro_torch.core import trainer, updates
    from repro_torch.core.corpus import tile_corpus
    from repro_torch.core.sampler import draw_sweep_uniforms, pick_search_block
    from repro_torch.data.synthetic import nytimes_like
    from repro_torch.kernels.ell_select import kernel as ell
    from repro_torch.kernels.ell_select import ref as ell_ref
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.lda_sample import ops as k1_ops
    from repro_torch.kernels.lda_sample import ref as k1_ref
    from repro_torch.kernels.phi_update import kernel as k24
    from repro_torch.kernels.phi_update import ops as phi_ops
    from repro_torch.kernels.phi_update import ref as k24_ref
    from repro_torch.train import fit

    dev = torch.device(device)

    # -- 7. host preparation -------------------------------------------------
    t0 = time.perf_counter()
    corpus = nytimes_like(scale, seed=0)
    t_corpus = time.perf_counter() - t0
    cfg = trainer.resolve_config(lda_nytimes.CONFIG, corpus)
    t0 = time.perf_counter()
    shard = tile_corpus(corpus, 1, cfg.tile_tokens)[0]
    t_tile = time.perf_counter() - t0
    t0 = time.perf_counter()
    shard = shard.to(dev)
    torch.cuda.synchronize()
    t_h2d = time.perf_counter() - t0
    t0 = time.perf_counter()
    seg = phi_ops.shard_segments(shard)      # K2's and K4's table, once
    torch.cuda.synchronize()
    t_seg = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows = phi_ops.shard_rows_to_zero(shard)  # K4's rows to zero, once
    torch.cuda.synchronize()
    t_rows = time.perf_counter() - t0
    n, t = shard.token_doc.shape
    V, K, P = corpus.num_words, cfg.num_topics, cfg.ell_capacity
    nb, bw = K // pick_search_block(K), pick_search_block(K)
    emit("train_prep", scale=scale, docs=corpus.num_docs, V=V, K=K, P=P,
         tiles=n, tile_tokens=t, real_tokens=shard.num_tokens,
         slots=n * t, max_doc_length=shard.max_doc_length,
         ell_dtype=str(updates.ell_dtype(K, shard.max_doc_length)),
         corpus_s=t_corpus, tiling_s=t_tile, to_device_s=t_h2d,
         k2_segments=int(seg.shape[0]),
         k2_sole_segments=int(seg[:, 3].sum()),
         k2_segment_tiles=k24.segment_tiles(), k2_table_s=t_seg,
         k4_rows_to_zero=int(rows.shape[0]), k4_rows_s=t_rows)

    # -- 8. K1 against its plain version on heavy + tail tiles; the ELL -----
    state0 = trainer.init_state(cfg, shard)
    theta0, ell_c, ell_t, _ = trainer.theta_and_ell(cfg, shard, state0.z)
    ell_dt = ell_c.dtype
    ell_err = ell_vs_plain(theta0, P, ell_dt, "initial")
    live0 = k1_ops.live_lengths(ell_c)
    uni = draw_sweep_uniforms(trainer.iteration_generator(cfg, 0, dev), n, t)
    full = (shard.tile_word, shard.token_doc, shard.token_mask, state0.z,
            state0.phi_vk, state0.phi_sum, ell_c, ell_t, uni)
    kw = dict(alpha=cfg.resolved_alpha(), beta=cfg.beta, num_words_total=V)
    k1_err = k1_vs_plain(full, kw, "initial")

    # -- 9. K2 and K4 against their plain versions at full V x K -------------
    z1, sp1, _ = k1.lda_sample_tiles(*full, ell_live=live0, **kw)
    tw, tf, tm = shard.tile_word, shard.tile_first, shard.token_mask
    k2_err, k4_err = counts_vs_plain("train_counts_vs_plain", shard, seg,
                                     rows, state0, z1, V, K, reuse=True)

    # -- 10. times at full width ---------------------------------------------
    words = tw.long()[:, None].expand(n, t)[tm]
    new_flat = words * K + z1[tm].long()
    old_flat = words * K + state0.z[tm].long()
    ones = torch.ones_like(new_flat, dtype=torch.int32)
    idx2, val2 = torch.cat([new_flat, old_flat]), torch.cat([ones, -ones])
    out_flat = torch.empty(V * K, dtype=torch.int32, device=dev)

    def library(ix, val):
        out_flat.zero_()
        out_flat.index_add_(0, ix, val)

    timing = {}
    timing["k1"] = dict(
        ms=time_ms(lambda: k1.lda_sample_tiles(*full, ell_live=live0, **kw)),
        plain_ms=time_ms(lambda: k1_ref.lda_sample_tiles_ref(
            *full, tiles_per_step=512, **kw), n=3, warm=1),
        **bound(*k1_bytes_and_ops(full, sp1, nb, bw), FP32_FLOPS))
    real_tok = shard.num_tokens
    timing["k2"] = dict(
        ms=time_ms(lambda: k24.phi_delta_tiles(seg, z1, state0.z, tm, V, K)),
        plain_ms=time_ms(lambda: k24_ref.phi_delta_tiles_ref(
            tw, tf, z1, state0.z, tm, V, K)),
        library_ms=time_ms(lambda: library(idx2, val2)),
        **bound(*count_bytes_and_ops(n, t, z1.element_size(), V, K, real_tok,
                                     True, table_bytes(seg)), INT32_OPS))
    timing["k4"] = dict(
        ms=time_ms(lambda: k24.phi_update_tiles(seg, rows, z1, tm, V, K)),
        plain_ms=time_ms(lambda: k24_ref.phi_update_tiles_ref(
            tw, tf, z1, tm, V, K)),
        library_ms=time_ms(lambda: library(new_flat, ones)),
        **bound(*count_bytes_and_ops(n, t, z1.element_size(), V, K, real_tok,
                                     False, table_bytes(seg, rows)),
                INT32_OPS))
    timing["ell"] = dict(
        ms=time_ms(lambda: updates.theta_to_ell(theta0, P, ell_dt)),
        plain_ms=time_ms(lambda: ell_ref.theta_to_ell_ref(theta0, P, ell_dt),
                         n=5, warm=1),
        **bound(ell_bytes(theta0, P, ell_dt), 0, INT32_OPS))
    group = k1.tiles_per_cta()
    emit("train_timing", card=card, state="initial", **timing,
         k1_design=k1_design(full, timing["k1"]["ms"], group))
    del words, new_flat, old_flat, ones, idx2, val2, z1, sp1, uni, full
    del state0, theta0, ell_c, ell_t, live0
    torch.cuda.empty_cache()

    # -- 11. the training main path ------------------------------------------
    counters = (k1.lda_sample_tiles, k24.phi_delta_tiles,
                k24.phi_update_tiles, ell.ell_select)
    for f in counters:
        f.launches = 0
    t0 = time.perf_counter()
    res = fit(corpus, lda_nytimes.CONFIG, iters, device=dev, shard=shard,
              eval_every=1)
    st = res.state
    rebuilt = phi_ops.phi_update(tw, tf, st.z, tm, num_words=V, num_topics=K,
                                 segments=seg, zero_rows=rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {f.__name__: f.launches for f in counters}
    tps = res.tokens_per_sec
    emit("train", card=card, iters=iters, compile_sec=res.compile_sec,
         tokens_per_sec=tps, median_tokens_per_sec=float(np.median(tps)),
         ll_per_token=res.ll_per_token,
         sparse_frac=[s[0] for s in res.stats],
         ell_overflow=[s[1] for s in res.stats],
         mean_s_over_sq=[s[2] for s in res.stats], launches=launches,
         wall_s=wall, peak_bytes=torch.cuda.max_memory_allocated(dev))
    if launches["lda_sample_tiles"] != iters + 1 or \
            launches["phi_delta_tiles"] != iters + 1:
        raise AssertionError(f"K1/K2 not launched once per iteration (+1 "
                             f"warm-up): {launches}")
    if launches["phi_update_tiles"] < 1:
        raise AssertionError("K4 was not launched on the training path")
    if launches["ell_select"] < iters + 1:
        raise AssertionError(f"the ELL kernel missed an iteration: {launches}")
    if not res.ll_per_token[-1] > res.ll_per_token[0]:
        raise AssertionError(f"LL/token did not rise: {res.ll_per_token}")
    if not torch.equal(st.phi_vk, rebuilt):
        raise AssertionError("phi != K4(z) after training")
    if not torch.equal(st.phi_sum, updates.phi_totals(st.phi_vk)):
        raise AssertionError("phi_sum != phi.sum(0)")
    if int(st.phi_vk.sum(dtype=torch.int64)) != corpus.num_tokens:
        raise AssertionError("phi.sum() != number of tokens")
    if not bool(((st.z >= 0) & (st.z < K)).all()):
        raise AssertionError("a topic assignment is outside [0, K)")
    del rebuilt
    theta1 = trainer.theta_and_ell(cfg, shard, st.z)[0]
    ell_err = max(ell_err, ell_vs_plain(theta1, P, ell_dt, "trained"))
    emit("train_ell_timing", card=card, state="trained", ms=time_ms(
        lambda: updates.theta_to_ell(theta1, P, ell_dt)))
    del theta1
    emit("train_step_memory", card=card,
         **step_memory(cfg, shard, st, seg, rows, dev))

    # -- 12-13. K1 against plain on the trained state; the step breakdown ----
    err, _ = trained_state_phases(card, cfg, shard, st, seg, kw, "trained",
                                  "train_breakdown")
    k1_err = max(k1_err, err)

    # -- 14. a profiler trace of two steady iterations -----------------------
    emit("train_profile", card=card, **profile_iterations(cfg, shard, st, 2))

    # -- 15. training over a process group -----------------------------------
    mesh_launches = mesh_phases(card, corpus, shard, seg, rows, st,
                                float(np.median(tps)), counters)
    for k, v in mesh_launches.items():
        launches[k] += v

    def row(name, src, replaces, key, err, launched):
        k = timing[key]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launched,
                "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
                "library_ms": k.get("library_ms")}

    ks = "src/repro_torch/kernels/"
    return [
        row("lda_sample_tiles", ks + "lda_sample/csrc/lda_sample.cu",
            "src/repro/kernels/lda_sample/kernel.py:194", "k1", k1_err,
            launches["lda_sample_tiles"]),
        row("phi_delta_tiles", ks + "phi_update/csrc/phi_update.cu",
            "src/repro/kernels/phi_update/kernel.py:81", "k2", k2_err,
            launches["phi_delta_tiles"]),
        row("phi_update_tiles", ks + "phi_update/csrc/phi_update.cu",
            "src/repro/kernels/phi_update/kernel.py:112", "k4", k4_err,
            launches["phi_update_tiles"]),
        row("ell_select", ks + "ell_select/csrc/ell_select.cu", "none",
            "ell", ell_err, launches["ell_select"]),
    ]


def step_memory(cfg, shard, st, seg, rows, dev) -> dict:
    """One more iteration from the trained state ``st`` (its uniforms drawn
    inside), between a reset of the card's peak and a read of it: the
    bytes held before it, of them the step's own (the shard's tiles, K2's
    table ``seg``, K4's rows ``rows``, the state), and the peak;
    ``dryrun --lda-card-run`` reckons
    the same step on fake tensors (without K4's rows, which a step does
    not read).  Not counted among the main path's launches."""
    import torch

    from repro_torch.core import trainer

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    nxt, _ = trainer.lda_iteration(cfg, shard, st)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    del nxt
    known = table_bytes(seg, rows, st.z, st.phi_vk, st.phi_sum, *(
        getattr(shard, f) for f in shard._TENSORS))
    return dict(held_bytes=held, peak_bytes=peak,
                transient_bytes=peak - held, held_step_bytes=known,
                held_other_bytes=held - known,
                k4_rows_bytes=table_bytes(rows),
                k2_table_bytes=table_bytes(seg))


def sharded_phase(card, snap, snap2, docs, majors, docs2, majors2,
                  dense_warm: dict, devices=None) -> int:
    """Phase 16 (module docstring): V-sharded serving of the planted model
    at full width.  Returns K3's launches on the sharded engines' runs.
    ``devices``: the blocks' devices (by default the placement rule of the
    docstring; a CPU rehearsal passes CPU entries)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from repro_torch.kernels.fold_in import kernel, ops
    from repro_torch.launch import serve_lda
    from repro_torch.serve import (InferConfig, SnapshotIntegrityError,
                                   load_sharded_snapshot,
                                   save_sharded_snapshot, shard_snapshot)
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.infer import (_host_batch_from_buffer,
                                         fold_in_config, fold_in_request,
                                         pack_docs, pack_request_buffer,
                                         routing_plan)

    if devices is not None:
        placement = "given: " + ", ".join(map(str, devices))
    elif torch.cuda.device_count() >= SHARDS:
        devices = tuple(torch.device("cuda", i) for i in range(SHARDS))
        placement = f"one block a card on cuda:0..{SHARDS - 1}"
    else:
        devices = (torch.device("cuda", 0),) * SHARDS
        placement = f"{SHARDS} blocks on cuda:0"
    t0 = time.perf_counter()
    sh = shard_snapshot(snap, SHARDS, devices=devices)
    sh2 = shard_snapshot(snap2, SHARDS, devices=devices)
    shard_s = (time.perf_counter() - t0) / 2

    # -- the sharded fold-in against the dense one, the same randoms -------
    burn_in, samples = SWEEPS
    Lb, K = BUCKETS[-1], snap.num_topics
    cfgs = {c: InferConfig(burn_in=burn_in, samples=samples, comm=c)
            for c in COMMS}
    tokens, mask = pack_docs(docs[:BATCH], Lb)
    gen = torch.Generator(device=snap.device)
    gen.manual_seed(17)
    randoms = ops.draw_fold_in_randoms(gen, BATCH, Lb, K, sum(SWEEPS),
                                       snap.device)
    dense = fold_in_config(snap, tokens, mask, randoms, cfgs["psum"])
    fields = ("theta", "top_topics", "sparse_frac", "mean_s_over_sq")
    equal, ssq_diff = {}, {}
    for comm, cfg in cfgs.items():
        got = fold_in_config(sh, tokens, mask, randoms, cfg)
        equal[comm] = {f: bool(torch.equal(getattr(got, f),
                                           getattr(dense, f)))
                       for f in fields}
        ssq_diff[comm] = float(got.mean_s_over_sq - dense.mean_s_over_sq)

    # -- device time and wall time a call, the engine's call path ----------
    packed = pack_request_buffer(docs[:BATCH], BATCH, Lb, 23)
    buf = torch.from_numpy(packed).to(snap.device)
    plan = routing_plan(sh, *_host_batch_from_buffer(packed))

    def call(s, comm):
        cap = None
        if comm == "all2all":     # the engine plans on the host each batch
            cap = routing_plan(s, *_host_batch_from_buffer(packed)).capacity
        return fold_in_request(s, buf, cfgs[comm], seed=23, capacity=cap)

    def wall_ms(fn, n=20):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return float(np.median(out))

    # a 4x hold: all2all's host path (3-8 ms a call) would outrun the
    # default one over 20 calls and time the host instead of the card
    timing = {"dense": dict(ms=time_ms(lambda: call(snap, "psum"), hold=4),
                            wall_ms=wall_ms(lambda: call(snap, "psum")))}
    for comm in COMMS:
        timing[comm] = dict(ms=time_ms(lambda: call(sh, comm), hold=4),
                            wall_ms=wall_ms(lambda: call(sh, comm)))
    emit("serve_sharded_fold_in", card=card, placement=placement,
         shards=SHARDS, devices=[str(d) for d in devices], B=BATCH, L=Lb,
         shard_s=shard_s, equal=equal, mean_s_over_sq_diff=ssq_diff,
         timing=timing, capacity=plan.capacity,
         routed_tokens=plan.routed_tokens, a2a_bytes=plan.a2a_bytes,
         psum_bytes=plan.psum_bytes)
    for comm, eq in equal.items():
        if not all(eq.values()):
            raise AssertionError(f"sharded fold-in ({comm}) differs from the "
                                 f"dense one: {eq}")

    # -- the main path: an engine per comm, then swaps across layouts ------
    planned = []     # the bytes of every plan the engines make
    real_plan, real_psum = engine_mod.routing_plan, engine_mod.psum_gather_bytes

    def plan_and_record(*a):
        p = real_plan(*a)
        planned.append(p.a2a_bytes)
        return p

    def psum_and_record(*a):
        planned.append(real_psum(*a))
        return planned[-1]

    engine_mod.routing_plan = plan_and_record
    engine_mod.psum_gather_bytes = psum_and_record
    kernel.fold_in_docs.launches = 0
    rows = {}
    try:
        for comm in COMMS:
            del planned[:]
            args = serve_lda.build_argparser().parse_args(
                ["--snapshot", "unused.npz", "--no-trace", "--comm", comm])
            model, engine = serve_lda.make_engine(args, sh)
            swaps = {}
            try:
                cold = burst(engine, docs, majors)
                warm = [burst(engine, docs, majors)
                        for _ in range(WARM_BURSTS)]
                if comm == "all2all":          # sharded -> dense -> sharded
                    for name, new in (("dense", snap2), ("sharded", sh2)):
                        v = model.publish(new)
                        res = engine.infer_many(docs2, timeout=300.0)
                        swaps[name] = dict(
                            version=v,
                            versions_ok=all(r["model_version"] == v
                                            for r in res),
                            recovered=float(np.mean(
                                [int(r["theta"].argmax()) == m
                                 for r, m in zip(res, majors2)])))
                stats = engine.stats()
            finally:
                engine.stop()
            p99s = [w["p99_ms"] for w in warm]
            rates = [w["docs_per_sec"] for w in warm]
            rows[comm] = dict(
                cold=cold, warm_p99_ms_median=float(np.median(p99s)),
                warm_p99_ms_min=min(p99s), warm_p99_ms_max=max(p99s),
                warm_docs_per_sec_median=float(np.median(rates)),
                warm_docs_per_sec_min=min(rates),
                warm_docs_per_sec_max=max(rates),
                recovered_min=min([cold["recovered"]]
                                  + [w["recovered"] for w in warm]),
                batches=stats["batches"],
                h2d_transfers=stats["h2d_transfers"],
                comm_bytes_moved=stats["comm_bytes_moved"],
                planned_bytes=float(sum(planned)), plans=len(planned),
                swaps=swaps)
    finally:
        engine_mod.routing_plan = real_plan
        engine_mod.psum_gather_bytes = real_psum
    launches = kernel.fold_in_docs.launches
    emit("serve_sharded", card=card, placement=placement, docs=len(docs),
         engines=rows, kernel_launches=launches,
         dense_warm_p99_ms_median=dense_warm["p99_ms_median"],
         dense_warm_docs_per_sec_median=dense_warm["docs_per_sec_median"])
    for comm, r in rows.items():
        if r["recovered_min"] < RECOVERY:
            raise AssertionError(f"{comm}: a sharded burst recovered "
                                 f"{r['recovered_min']} of planted topics")
        if r["comm_bytes_moved"] != r["planned_bytes"] or r["plans"] < 1:
            raise AssertionError(f"{comm}: comm_bytes_moved "
                                 f"{r['comm_bytes_moved']} != the plans' "
                                 f"{r['planned_bytes']}")
        if r["h2d_transfers"] != r["batches"]:
            raise AssertionError(f"{comm}: {r['h2d_transfers']} H2D copies "
                                 f"for {r['batches']} batches")
    versions = [s["version"] for s in rows["all2all"]["swaps"].values()]
    if versions != [2, 3] or not all(
            s["versions_ok"] and s["recovered"] >= RECOVERY
            for s in rows["all2all"]["swaps"].values()):
        raise AssertionError(f"hot-swaps: {rows['all2all']['swaps']}")
    if launches < 1:
        raise AssertionError("the sharded engines never launched K3")

    # -- the .sharded directory of the planted model ----------------------
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        path = save_sharded_snapshot(os.path.join(tmp, "planted.sharded"), sh)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = load_sharded_snapshot(path, devices=devices)
        read_s = time.perf_counter() - t0
        same = bool(torch.equal(back.assemble().phi_vk, snap.phi_vk)
                    and torch.equal(back.phi_sum, snap.phi_sum))
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        del back
        shard = os.path.join(path, "shard_0002.npz")
        raw = bytearray(open(shard, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(shard, "wb").write(bytes(raw))
        try:
            load_sharded_snapshot(path, devices=devices)
            refused = False
        except SnapshotIntegrityError:
            refused = True
    emit("serve_sharded_disk", card=card, write_s=write_s, read_s=read_s,
         bytes_on_disk=size, phi_equal=same, corrupt_refused=refused)
    if not (same and refused):
        raise AssertionError("the .sharded round trip failed")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; nothing was run",
              file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.configs import lda_nytimes
    from repro_torch.kernels import _build
    from repro_torch.kernels.fold_in import kernel, ref
    from repro_torch.launch import serve_lda

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit("card", nvidia_smi=card, torch_name=kind,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # -- 2. build every kernel from the checkout's sources -----------------
    t0 = time.perf_counter()
    logs = _build.build_all(KERNELS)
    emit("build", seconds=time.perf_counter() - t0, ptxas={
        name: [ln.strip() for ln in log.splitlines()
               if "registers" in ln or "spill" in ln]
        for name, log in logs.items()})

    # -- planted NYTimes-width model on the card ----------------------------
    V = lda_nytimes.FULL["num_words"]
    K = lda_nytimes.NUM_TOPICS
    avg_len = lda_nytimes.FULL["avg_doc_len"]
    t0 = time.perf_counter()
    snap = serve_lda.planted_snapshot(V, K, seed=0)
    _, home = serve_lda.planted_model(V, K, seed=0)
    docs, majors = serve_lda.planted_docs(home, K, SERVE_DOCS, avg_len,
                                          seed=1)
    emit("model", V=V, K=K, phi_bytes=snap.phi_vk.numel() * 4,
         seconds=time.perf_counter() - t0)

    # -- 3. kernel against plain version at every bucket, full width -------
    max_abs_err = 0
    for Lb in BUCKETS:
        cmp = fold_in_vs_plain(snap, docs, Lb, V)
        emit("kernel_vs_plain", **cmp)
        max_abs_err = max(max_abs_err, cmp["theta_sum_max_abs_err"])
        where = f"at L = {Lb}, launch shape {cmp['shape']}"
        if cmp["one_sweep_flip_rate"] > ONE_SWEEP_MISMATCH:
            raise AssertionError(
                f"one-sweep draws differ on {cmp['one_sweep_flips']}/"
                f"{cmp['real_tokens']} {where}")
        sp_agree, arg_agree = (cmp["sp_doc_agreement"],
                               cmp["argmax_doc_agreement"])
        if sp_agree < DOC_AGREEMENT or arg_agree < DOC_AGREEMENT:
            raise AssertionError(
                f"doc agreement sp={sp_agree} argmax={arg_agree} {where}")
        if cmp["mean_theta_l1"] > MEAN_THETA_L1:
            raise AssertionError(f"mean theta L1 {cmp['mean_theta_l1']} > "
                                 f"{MEAN_THETA_L1} {where}")

    # -- 4. times at each L bucket, B = 32 ----------------------------------
    burn_in, samples = SWEEPS
    rows = []
    for Lb in BUCKETS:
        args = gathered_batch(snap, docs[:BATCH], Lb, seed=13,
                              n_sweeps=sum(SWEEPS))
        kwb = dict(num_words_total=V, burn_in=burn_in, samples=samples,
                   ell_capacity=min(Lb, K))
        z_final = kernel.fold_in_docs(*args, **kwb)[3].cpu()
        k_ms = time_ms(lambda: kernel.fold_in_docs(*args, **kwb))
        p_ms = time_ms(lambda: ref.fold_in_docs_ref(*args, **kwb))
        nbytes, ops = bytes_and_ops([a.cpu() for a in args], sum(SWEEPS),
                                    z_final)
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        rows.append(dict(B=BATCH, L=Lb, P=min(Lb, K), ms=k_ms, plain_ms=p_ms,
                         shape=kernel.launch_shape(BATCH, Lb, K,
                                                   min(Lb, K)),
                         bytes=nbytes, ops=ops, bytes_ms=b_ms, ops_ms=o_ms,
                         bound_ms=max(b_ms, o_ms),
                         bound_by="bytes" if b_ms >= o_ms else "operations"))
    emit("timing", card=card, buckets=rows)

    # -- 5. the main path: engine on the planted snapshot, then a hot-swap --
    args = serve_lda.build_argparser().parse_args(
        ["--snapshot", "unused.npz", "--no-trace"])
    model, engine = serve_lda.make_engine(args, snap)
    kernel.fold_in_docs.launches = 0
    t0 = time.perf_counter()
    try:
        results = engine.infer_many(docs, timeout=300.0)
        stats = engine.stats()
        warm = [burst(engine, docs, majors) for _ in range(WARM_BURSTS)]
        snap2 = serve_lda.planted_snapshot(V, K, seed=1)
        _, home2 = serve_lda.planted_model(V, K, seed=1)
        docs2, majors2 = serve_lda.planted_docs(home2, K, SWAP_DOCS, avg_len,
                                                seed=2)
        version = model.publish(snap2)
        results2 = engine.infer_many(docs2, timeout=300.0)
    finally:
        engine.stop()
    launches = kernel.fold_in_docs.launches
    wall = time.perf_counter() - t0
    theta = np.stack([r["theta"] for r in results + results2])
    recovered = float(np.mean([int(r["theta"].argmax()) == m
                               for r, m in zip(results, majors)]))
    recovered2 = float(np.mean([int(r["theta"].argmax()) == m
                                for r, m in zip(results2, majors2)]))
    lat = np.asarray([r["latency_ms"] for r in results])
    emit("serve", card=card, docs=len(results), batches=stats["batches"],
         mean_batch=stats["mean_batch"],
         truncated=int(sum(r["truncated"] for r in results)),
         p50_ms=float(np.percentile(lat, 50)),
         p90_ms=float(np.percentile(lat, 90)),
         p99_ms=float(np.percentile(lat, 99)),
         docs_per_sec=stats["docs_per_sec"], recovered=recovered,
         swap_version=version, swap_docs=len(results2),
         swap_recovered=recovered2, kernel_launches=launches,
         h2d_transfers=stats["h2d_transfers"], wall_s=wall)
    if not np.allclose(theta.sum(1), 1.0, atol=SUM_ATOL):
        raise AssertionError("a served theta does not sum to 1")
    if recovered < RECOVERY or recovered2 < RECOVERY:
        raise AssertionError(f"planted topic recovered on {recovered} / "
                             f"{recovered2} of docs")
    if any(r["model_version"] != version for r in results2):
        raise AssertionError("an answer after the swap has an old version")
    if launches < 1:
        raise AssertionError("the main path never launched the kernel")
    p99s = [w["p99_ms"] for w in warm]
    rates = [w["docs_per_sec"] for w in warm]
    emit("serve_warm", card=card, docs=len(docs), bursts=warm,
         p99_ms_median=float(np.median(p99s)), p99_ms_min=min(p99s),
         p99_ms_max=max(p99s), docs_per_sec_median=float(np.median(rates)),
         docs_per_sec_min=min(rates), docs_per_sec_max=max(rates))
    if min(w["recovered"] for w in warm) < RECOVERY:
        raise AssertionError("a warm burst recovered too few planted topics")

    # -- 6. where the time goes: the same storm, warm and traced ------------
    args = serve_lda.build_argparser().parse_args(["--snapshot", "unused.npz"])
    model, engine = serve_lda.make_engine(args, snap2)
    try:
        engine.infer_many(docs2[:BATCH], timeout=300.0)      # warm
        engine.obs.tracer.clear()
        t0 = time.perf_counter()
        engine.infer_many(docs, timeout=300.0)
        traced_wall = time.perf_counter() - t0
    finally:
        engine.stop()
    spans = {}
    for ev in engine.obs.tracer.to_chrome()["traceEvents"]:
        if ev.get("ph") == "X":
            n, tot = spans.get(ev["name"], (0, 0.0))
            spans[ev["name"]] = (n + 1, tot + ev["dur"] / 1e3)
    emit("serve_traced", card=card, docs=len(docs), wall_s=traced_wall,
         spans={k: dict(count=n, total_ms=tot, mean_ms=tot / n)
                for k, (n, tot) in sorted(spans.items())})

    # -- 16. V-sharded serving at full width --------------------------------
    launches += sharded_phase(
        card, snap, snap2, docs, majors, docs2, majors2,
        dict(p99_ms_median=float(np.median(p99s)),
             docs_per_sec_median=float(np.median(rates))))

    main_row = rows[-1]
    k3_row = {
        "name": "fold_in_docs", "route": "cuda",
        "source": "src/repro_torch/kernels/fold_in/csrc/fold_in.cu",
        "replaces": "src/repro/kernels/fold_in/kernel.py:184",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None}
    del snap, snap2, model, engine, args
    torch.cuda.empty_cache()

    train_rows = train_phases(card, TRAIN_SCALE, TRAIN_ITERS)
    torch.cuda.empty_cache()

    # -- 17. PubMed at full width ------------------------------------------
    from repro_torch.kernels.ell_select import kernel as ell
    from repro_torch.kernels.lda_sample import kernel as k1
    from repro_torch.kernels.phi_update import kernel as k24
    train_counters = (k1.lda_sample_tiles, k24.phi_delta_tiles,
                      k24.phi_update_tiles, ell.ell_select)
    pm_launches, k2_err, k4_err, k1_err = pubmed_phase(
        card, PUBMED_SCALE, PUBMED_ITERS, train_counters)
    torch.cuda.empty_cache()

    # -- 18. the examples on the card ---------------------------------------
    ex_launches = examples_phase(card, (kernel.fold_in_docs,)
                                 + train_counters)
    k3_row["launches"] += ex_launches["fold_in_docs"]
    errs = dict(lda_sample_tiles=k1_err, phi_delta_tiles=k2_err,
                phi_update_tiles=k4_err,
                ell_select=0)   # phase 17's ELL check raises on a difference
    for row in train_rows:
        row["launches"] += pm_launches[row["name"]] + ex_launches[row["name"]]
        row["max_abs_err"] = max(row["max_abs_err"], errs[row["name"]])
    torch.cuda.empty_cache()

    # -- 19-21. the LM zoo's serving path ------------------------------------
    lm_archs_phase(card)
    qwen_phase(card)
    lm_launcher_phase(card)

    # -- 22-24. the LM zoo's training path -----------------------------------
    lm_train_archs_phase(card)
    first_losses = qwen_train_phase(card)
    lm_train_launcher_phase(card)

    # -- 25. the LM zoo's training over a mesh -------------------------------
    lm_mesh_phase(card, first_losses)

    # -- 26. the LM zoo's serving over a mesh --------------------------------
    lm_serve_mesh_phase(card)

    # -- 27. a recurrent arch at full width ----------------------------------
    mamba_phase(card)
    print(json.dumps({"kernels": [k3_row] + train_rows}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
