#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

  python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. build every CUDA kernel of the training paths from
     ``src/repro_torch/csrc`` (one nvcc per source, all started together)
     and print the build time and ptxas's register and spill lines;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at a ragged shape, and time the kernel, the
     plain version and, where one exists, a one-call PyTorch yardstick:
     ``cco_stats`` in both moment sets (to 1e-5 x (1 + max|plain|), a
     second run bit-equal, cov_f and cov_g exactly symmetric, the full
     set's cross statistics bit-equal to the cross set's) at (N, d) =
     (128, 1024), the token path's (8, 1024), (37, 1000) and (4096, 1024),
     ``quant_dequant`` in both scale forms (bit for bit)
     and ``segment_sum`` (bit for bit, and the same on a second run) at
     every (K, D, E) its paths give it, a ragged shape with padding ids
     and empty segments, and one segment per client (phase 11's streamed
     tree included: a chunk of STREAM_CHUNK rows of each payload into its
     one edge, and the STREAM_K-row edge mass into 8); then
     ``hierarchy.fold_to_edges`` end to end at the deltas shape, K into 8
     edges and STREAM_CHUNK into 1, beside the kernel alone;
  3. the Appendix-A equivalence at full width, for DCCO and for D-VICReg:
     one round against one centralized step on the same 64-client cohort;
  4. six training paths through ``repro_torch.launch.train --full`` on
     64 clients x 2 samples of 2048 synthetic 32x32 images, each with every
     kernel launch count set to 0 just before and read just after, and held
     to the launches its code makes:
     DCCO (5 rounds; the "cross" statistics kernel once a round), D-VICReg
     (3 rounds; the "full" statistics kernel once a round), DCCO over an
     int8 uplink (3 rounds; the column-mapped quantize kernel twice a round,
     no statistics kernel), and, 3 rounds each, the two-level tree over 8
     edges with an int8 client hop (segment_sum 3 a round, quantize 2),
     clustered aggregation over 4 clusters (segment_sum 8 a round) and the
     buffered engine (segment_sum 2 a tick);
  5. ``mips_topk`` in both forms against its plain version (scores to
     1e-5, indices equal but for near ties, a second run bit-equal) at the
     training eval's shape (512, 1536), the serving shape (64, 16384) in
     f32 and bf16, a deployed index of 2^20 rows (Q = 16 and 64), a large
     batch (1024, 65536, k = 32) and a ragged 1,000,003-row corpus, whose
     4 zero-padded shards through the offset form merge to the unsharded
     result bit for bit; duplicated rows must tie to the lowest index;
  6. a seventh training path, DCCO with the retrieval eval after every
     round (3 rounds; cco_stats and one mips_topk search a round, recall
     and MRR in [0, 1]), and the serving surface on the encoder it
     trained: CorpusIndex over 16,384 images in f32 and bf16, QueryServer
     (batch 64, k 10) over 32 batches equal to index.search,
     ShardedCorpusIndex x 4 equal bit for bit, and IVFIndex over 128 lists
     (k-means on segment_sum; every list probed equals the exact tier);
     then the serving rate: QueryServer over a deployed index of 2^20
     random unit rows (f32 and bf16), 512 batches back to back, p50, p99
     and qps. Each surface's launches are read in a window of its own,
     with the comparisons outside it, and held exact;
  7. ``flash_attention`` against its plain version (f32 to 2e-5, bf16 to
     3e-2, the row log-sum-exp to 2e-5 (1 + |lse|)) at the TinyLlama
     path's shape (phase 1 and phase 2 both give B = K * n), Dh 128 in
     groups of 2, the smoke configs' Dh 32 in f32, windows 32 and 96,
     non-causal, Sq 64 of Skv 128, a ragged S of 100, TinyLlama's heads
     at B = 1 over 4096 positions and (B, S, H, Dh) views read in place
     (bit-equal to their contiguous copies), each timed beside its plain
     version and ``scaled_dot_product_attention`` (a yardstick the port
     never calls); at each of those shapes, and wherever a later phase
     holds the forward, the backward kernel
     (``csrc/flash_attention_bwd.cu``) against its plain version, the
     blockwise recompute (dq, dk and dv to FLASH_BWD_TOL of the largest
     gradient, a second run bit-equal), timed beside it and SDPA's
     backward at the path's shape, over 4096 positions, where its peak
     memory above its inputs is gated (FLASH_BWD_SLACK), and (phase 12)
     at MLA's (192, 128) prefill shape in bf16; its f32 route at every
     (Dqk, Dv): Dh 32, the text example's shape (8, 8, 2, 32, 32, Dh
     32; timed), the path's shape (timed), Dh 128, MLA's and zamba2's f32
     shapes (phases 12 and 13, timed) and, backward only, where its
     accumulators flush: TinyLlama's heads over 4096 positions (timed),
     over 1024 (the group split and folded) and Sq 64 of Skv 1100; the
     gradient of the autograd Function against autograd of the plain
     version at the path's shape in f32; then, after the serving phase's memory is
     released, D-CCO training of the full-width TinyLlama-1.1B token dual
     encoder (TOK_ROUNDS rounds, TOK_K clients x 2 sequences of 128
     tokens, bf16 weights from seed 0): losses finite, peak device memory
     printed, launches exactly 88 flash attention forwards a round (2
     views x 22 layers in the no-grad phase 1, the same again in phase 2,
     where vmap folds the K clients into one launch), 44 backward calls a
     round (phase 2's, one for all clients) and one "cross" statistics
     kernel;
  8. the paper's FedAvg baselines and the server strategies (the ResNet
     paths right after those of phase 4, the token path at the end of
     phase 7), each through ``train.run`` (the CLI's run with the engine's
     algorithm chosen) at full width, PATH_ROUNDS rounds from seed 0,
     launches held exact:
     FedAvg+CCO, FedAvg+NT-Xent and FedAvg+BYOL on the ResNet (no kernel:
     no phase 1), FedAvg+NT-Xent over an int8 uplink (the column quantize
     kernel once a round: the deltas are the only uplink), FedAvg+CCO
     through the tree of 8 edges with an int8 client hop (segment_sum
     twice a round, the begin-round mass and the deltas fold; quantize
     once), D-CCO with ``--server-opt fedadam`` (the "cross" statistics
     kernel once a round), then D-CCO and the centralized step over the
     same rounds for one Table-1-style line of probes (not gated: the
     random-init probe is high on these synthetic images); after the
     token D-CCO path, FedAvg+NT-Xent on the full-width TinyLlama-1.1B
     tower, TOK_ROUNDS rounds (flash attention forward and backward 2
     views x 22 layers a round, all in the vmapped phase 2), with its peak
     memory beside D-CCO's;
  9. client-drift correction and bf16 compute (the ResNet paths after
     those of phase 8, the token path at the end), each through
     ``train.run`` at full width, PATH_ROUNDS rounds from seed 0, launches
     held exact, the ResNet paths' parameters f32, the paths with two
     local steps at the small client lr that keeps them finite (LR_*
     below): D-CCO with FedProx
     (``--fedprox-mu 0.01 --local-steps 2``; "cross" once a round), with
     SCAFFOLD (``--scaffold --local-steps 2``; "cross" once a round, the
     variate average a ``tensordot``), SCAFFOLD over an int8 uplink (the
     column quantize kernel 3 a round: statistics, deltas, variate
     deltas), SCAFFOLD through the tree of 8 edges (segment_sum 4 a round:
     the mass and the three payloads; quantize 3), the buffered engine
     with SCAFFOLD (segment_sum 2 a tick, the variates refreshed at
     dispatch), FedAvg+CCO with SCAFFOLD (no kernel), D-CCO at
     ``--compute-dtype bfloat16`` ("cross" once a round; the bf16 tower's
     encodings reach ``cco_stats`` as f32, checked beside it); the
     SCAFFOLD paths print the variate deltas' share of the uplink; then
     D-CCO with FedProx on the full-width TinyLlama-1.1B tower, TOK_ROUNDS
     rounds (two local steps: flash 44 + 2 x 44 forwards and 2 x 44
     backwards a round, "cross" once), with its peak memory beside
     D-CCO's.
  10. serving and checkpoints: the full-width TinyLlama-1.1B tower (bf16
     weights from seed 0) serving through ``repro_torch.launch.serve``:
     prefill of SRV_B x SRV_PROMPT tokens and SRV_DECODE greedy decode
     steps, once with the model-dtype KV cache and once with the int8
     cache, each in a window of its own (flash attention 22 launches for
     the prefill, none for the decode steps), every step's logits held
     to the last position of a full forward over the prompt and the
     tokens generated so far, and the int8 cache's to the model-dtype
     cache's while their tokens agree (SRV_TOL x max(1, max |logits|)
     each), prefill ms, decode ms a token and peak memory printed, then
     SRV_PROFILE decode steps of each cache under ``torch.profiler`` (the
     device's busy share of the wall, device records a step); the dual
     encoder over that tower saved and restored bit for bit, then
     ``serve.run_retrieval`` with ``--ckpt`` of that file over token
     corpora of RET_SIZES sequences, in its three tiers (exact, 2 shards,
     IVF), each window's launches exact, the flash, MIPS (search and each
     shard's offset form) and segment-sum kernels held to their plain
     versions at the tiers' shapes, and the tiers' results held to the
     exact one; an f32 and a bf16 ``CorpusIndex`` saved and loaded on the
     card, searches equal before and after; then the ResNet's D-CCO with
     SCAFFOLD through ``train --ckpt-dir --ckpt-every 2`` over 4 rounds
     (the blob of round 2 restored equal, bit for bit, to what the engine
     saved: params, Adam state, variates), resumed from round 2 with
     ``--resume``, its parameters after round 4 held to the uninterrupted
     run's within the distance between two uninterrupted runs (measured
     in the same phase, cuDNN's deterministic algorithms on).
  11. streamed cohorts and the training modes, each window's launches
     held exact: (a) D-CCO on the ResNet over STREAM_K clients a round,
     streamed in chunks of STREAM_CHUNK (``train --cohort-chunk``), no
     kernel (the statistics kernel is refused on streamed rounds);
     (b) the same through the tree of 8 edges with an int8 client hop, one
     edge a chunk (the column quantize kernel 2 a chunk, segment_sum 1 + 2
     a chunk), its peak memory and ms/round printed beside the
     materialized 64-client D-CCO path's; (c) one lossless round at K
     streamed in chunks of EQ_CHUNK against the materialized round from
     the same round generator: the sampled cohorts equal bit for bit, the
     parameters within STREAM_TOL of the update (the distance printed);
     (f) ``--mode fused`` and ``--mode protocol`` on the ResNet, no kernel;
     (d) D-CCO on the full-width TinyLlama-1.1B streamed at K =
     TOK_STREAM_KS in chunks of TOK_CHUNK (flash attention 88 forwards
     and 44 backwards a chunk), both peaks printed; (e) ``--mode fused
     --micro FUSED_MICRO`` on TinyLlama-1.1B over FUSED_K clients x 2
     sequences (flash 132 forwards a microbatch: phase 1, the
     checkpointed forward and its recompute; 44 backwards),
     then the micro FUSED_MICRO step's gradient against the micro 1
     step's on GRAD_B sequences, within GRAD_TOL.
  12. the DeepSeek family at full config, weights from seed 0 drawn on the
     card: (a) the flash kernel's (Dqk 192, Dv 128) instance against its
     plain version at MLA's prefill shape (B = DS_B, H = KVH = 16, S =
     DS_PROMPT, causal, bf16) and in f32, timed beside its bound and SDPA
     ("none" where no backend takes Dv != Dqk); (b) deepseek-moe-16b (28
     layers, GQA, 64 + 2 experts, top 6) served through
     ``serve.generate``: prefill of DS_B x DS_PROMPT and DS_DECODE greedy
     steps with the model-dtype and the int8 cache, each in a window of
     its own (flash 28 a prefill, none in decode), prefill ms, decode ms
     a token, peak GiB and the dropped share of the routing at the
     published capacity factor 1.25 (prefill groups of 512, decode
     groups of B: capacity 1); then the decode gate at a capacity factor
     with no drops: every step's logits against a full forward over the
     same tokens with the serving path's top-k picks imposed, all held to
     SRV_TOL, and against the free forward, the (sequence, step) pairs
     whose picks flip between the two printed and the rest held to
     SRV_TOL; 4 decode steps under ``torch.profiler``; (c)
     deepseek-v2-lite-16b (27 layers, MLA) the same with the model-dtype
     cache (the MLA cache ignores kv_cache_dtype: checked), its prefill
     on the (192, 128) instance (27 a prefill), decode absorbed over the
     latent cache, and one absorbed step against one naive step; (d)
     D-CCO through ``train --num-layers 2 --cohort-chunk DS_CHUNK`` on
     each tower cut to its dense prologue and one MoE layer at full
     width (~0.9B parameters), DS_K clients x 2 sequences of 128,
     DS_ROUNDS rounds: losses finite, ms a round, peak GiB, flash 8 a
     chunk. Each tower is freed before the next.
  13. the recurrent families at full config, weights from seed 0 drawn on
     the card: (a) the flash kernel's (80, 80) instance against its plain
     version at zamba2's attention shape (B = REC_B, H = KVH = 32, S =
     REC_PROMPT, causal, bf16) and in f32 at a ragged Sq 100 of Skv 150,
     timed beside its bound and SDPA; (b) zamba2-2.7b (54 layers: 9
     superblocks of 5 Mamba2 + 1 attention block) served through
     ``serve.generate``: prefill of REC_B x REC_PROMPT and REC_DECODE
     greedy steps with the model-dtype and the int8 cache, each in a
     window of its own (flash 9 a prefill, none in decode): parameter
     count, prefill ms, decode ms a token, peak GiB; (c) xlstm-350m (24
     layers: 12 mLSTM + 12 sLSTM) the same with one cache (the recurrent
     states ignore kv_cache_dtype: checked; no flash launch); the decode
     gate of (b) and (c): each step's logits against the last position
     of a full forward over the same tokens (the forward's scans as one
     chunk of the sequence's length, as the reference asserts the chunk
     divides it). In bf16 the distances are printed a step,
     beside the bf16 noise floor (two full forwards of the same tokens,
     their f32 scans chunked differently) and block by block: rounding
     compounded over the depth moves the logits by several percent, so
     they are not gated.
     The gate serves the same weights in f32 compute with each cache and
     holds every step within SRV_TOL x max(1, max |logits|), printing the
     distance block by block if a step departs; (d) D-CCO through ``train
     --stats-kernel fused`` (materialized, ``cco_stats`` once a round) on
     xlstm-350m cut to 4 layers and zamba2-2.7b cut to one superblock
     (``--num-layers 4`` and ``6``), REC_K clients x 2 sequences of 128,
     bf16,
     REC_ROUNDS rounds: losses finite, ms a round, peak GiB, the
     ``cco_stats`` and flash launches a round. Each tower is freed before
     the next.
  14. the last two archs at full config, weights from seed 0 drawn on the
     card: (a) the flash kernel against its plain version at the new
     shapes, timed beside its bound and SDPA: internvl2-2b's prefill (B =
     MM_B, H 16, KVH 8, Dh 128, 256 patches + MM_PROMPT tokens), its Fig.
     1c view 2 (FIG1C_N sequences of 1 token + 256 patches, a ragged 257)
     and musicgen-large's prefill (H = KVH = 32, Dh 64); ``cco_stats``
     cross at internvl2-2b's projection width (8, 2048); (b) internvl2-2b
     (24 layers, 1.7B) served through ``serve.generate`` with 256 random
     patch embeddings: prefill and MM_DECODE greedy steps with the
     model-dtype and the int8 cache, each in a window of its own (flash 24
     a prefill, none in decode), the cache sized as the reference sizes it
     (prompt + gen + 1: the patches overflow it, its distance from a full
     forward printed, not gated); (c) musicgen-large (48 layers, 3.2B) the
     same without patches (flash 48 a prefill); the decode gate of (b) and
     (c) over a cache of every position, each step's logits against the
     last position of a full forward over the same patches and tokens
     within SRV_TOL x max(1, max |logits|), beside the bf16 noise floor
     (two full forwards, attention on the flash kernel and in plain
     torch); (d) D-CCO through ``train --stats-kernel
     fused`` on each tower cut to MM_CUTS layers, MM_K clients x 2
     sequences of 128, MM_ROUNDS rounds (internvl2-2b on its text views,
     as the reference trains it: the patch projector stays as
     initialised, checked): losses finite, ms a round, peak GiB, flash 4
     forwards and 2 backwards a layer and round, ``cco_stats`` once a
     round (at d = 2048 for
     internvl2-2b); (e) one ``steps.make_dcco_train_step`` step on the
     internvl2-2b cut over the paper's cross-modal pair (Fig. 1c), the
     batch laid out by ``launch.inputs.train_input_specs``: a finite
     loss, a nonzero gradient of the patch projector, flash 2 forwards
     and 2 backwards a layer.
  15. the cohort sharded over devices, on a world of one NCCL rank (see
     its comment block).
  16. the nine examples of ``repro_torch.examples`` through their
     ``main``, each in a launch window of its own held to the launches
     its path makes (EXAMPLES), with the quickstart's Appendix-A check in
     f64; and, in phase 15's world, ``make_production_mesh`` (1, 1) with
     ``multi_pod`` refused, the full-width TinyLlama-1.1B laid out by
     ``sharding.specs`` with ``distribute_tensor`` and back bit for bit,
     and every token arch's bytes a device on the 256-GPU stand-ins.
  17. the dry run (``launch/dryrun.py``): (a) DRY_CASES, every family, on
     fake worlds of 256 and 512 ranks with fake ``cuda`` tensors, each
     arch cut to one superblock (its prologue kept) at full width, train
     at DRY_MICRO microbatches (TinyLlama's train_4k also with the
     shard_map and the per-client loss, at micro 1), the cases in
     parallel worker processes: one roofline line a case, with its wire
     bytes by mesh axis; (b) on a fake world of one, the fake trace of
     TinyLlama-1.1B's fused step (DRY_B sequences of DRY_S, full depth,
     micro 1), then the same step run for real on the card in a launch
     window (flash forward and backward as many times as the trace
     recorded, both held against their plain versions at the step's
     shape): the FLOPs (``FlopCounterMode`` plus the flash formulas)
     equal to the trace's, and
     ``max_memory_allocated`` within DRY_BAND of the trace's peak; then
     the same for the shard_map step, its real run on a world of one
     NCCL rank with the explicit mesh (phase 15's world, joined anew).
Then one JSON line of kernel figures, and the device line last.
Needs a CUDA device and the repository's ``src/`` beside this file.
"""
import contextlib
import dataclasses
import gc
import importlib
import io
import json
import math
from pathlib import Path
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import comm, utils  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    restore_checkpoint, save_checkpoint)
from repro_torch.configs.base import (  # noqa: E402
    ARCH_IDS, DualEncoderConfig, TrainConfig, get_config,
    get_dual_encoder_config)
from repro_torch.core import fed_sim, round_engine  # noqa: E402
from repro_torch.data import partition, pipeline, synthetic  # noqa: E402
from repro_torch.hierarchy import (  # noqa: E402
    contiguous_edge_ids, fold_to_edges)
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels.cco_stats import cco_stats  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttention, flash_attention)
from repro_torch.kernels.quantize import quant_dequant  # noqa: E402
from repro_torch.kernels.mips_topk import mips_topk  # noqa: E402
from repro_torch.kernels.segment_sum import segment_sum  # noqa: E402
from repro_torch.launch import serve as serve_cli, train  # noqa: E402
from repro_torch.launch import inputs as inputs_lib  # noqa: E402
from repro_torch.launch import steps as steps_lib  # noqa: E402
from repro_torch.launch.profile_round import device_time  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import dual_encoder, transformer  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.common import embed, rmsnorm  # noqa: E402
from repro_torch.objectives import get_objective  # noqa: E402
from repro_torch.optim import optimizers as opt_lib, schedules  # noqa: E402
from repro_torch import hierarchy, retrieval  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    HardwareSpec, make_debug_mesh, make_production_mesh)
from repro_torch.sharding import (  # noqa: E402
    collectives, make_corpus_mesh, maybe_initialize_distributed, specs)
from tools.time_cco_stats import eager_ms, time_ms  # noqa: E402
from tools.time_flash import (  # noqa: E402
    flash_bound_ms, flash_bwd_bound_ms, sdpa_backward_ms)

ROUNDS = 5            # the DCCO path
PATH_ROUNDS = 3       # every other path
K, N_PER_CLIENT, DATASET = 64, 2, 2048
MAIN_N, MAIN_D = K * N_PER_CLIENT, 1024   # phase-1 rows, projection width
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor FLOP/s
PEAK_BYTES, PEAK_F32 = HardwareSpec.PEAK_BYTES, HardwareSpec.PEAK_F32
# kernel vs plain: max |kernel - plain| <= TOL * (1 + max |plain|); both
# sum f32 products of unit-normal data in other orders, the kernel each
# product as a TF32 and two bf16 remainder products (~2^-20 of it) summed
# from zero every 32 rows (tests/test_torch_kernel_numerics.py)
TOL = 1e-5
QMAX = 127.0          # the int8 channel
# MIPS kernel vs plain version: |score - plain score| <= MIPS_TOL; both sum
# d = 1024 f32 products of unit vectors in other orders (a typical error is
# sqrt(d) 2^-24 = 2e-6). An index may differ only where the plain scores
# of the two picks lie within MIPS_TOL of each other (a near tie).
MIPS_TOL = 1e-5
MIPS_K = 10                       # the training eval's and the server's k
SERVE_N, SERVE_BATCH, SERVE_BATCHES = 16384, 64, 32
RATE_N, RATE_BATCHES = 1 << 20, 512   # the serving rate's deployed index
IVF_C, IVF_NPROBE = 128, 8
# the token path: TinyLlama-1.1B at full width (22 layers, H 32, KVH 4,
# Dh 64, bf16), TOK_K clients x TOK_N sequences of TOK_S tokens
TOK_ARCH, TOK_LAYERS, TOK_K, TOK_N, TOK_S = "tinyllama-1.1b", 22, 4, 2, 128
# the token paths' rounds: two keep the script near half its time limit
TOK_ROUNDS = 2
TOK_PATH = "TinyLlama path (phase 1 = phase 2 folded)"   # check_flash label
PEAK_TF32 = HardwareSpec.PEAK_TF32   # H100 SXM dense TF32 tensor-core FLOP/s
# flash attention vs plain: both compute in f32 from the same inputs, in
# other orders; a bf16 output is rounded once on each side (1 bf16 ulp of
# an output below 4 is under 3e-2), as tests/test_kernels.py holds it
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# the attention backward kernel vs its plain version (the blockwise
# recompute): both compute in f32 from the same inputs, output and row
# log-sum-exp, in other orders, and a bf16 gradient is rounded once on
# each side (1 bf16 ulp is 2^-8 of a value); each of dq, dk and dv is held
# to FLASH_BWD_TOL x the largest magnitude of the three (where a mask
# leaves a row a single key, dq and dk vanish and both sides hold only
# rounding). Its peak memory above its inputs: dq, dk, dv, the (B, H, Sq)
# f32 delta and FLASH_BWD_SLACK bytes.
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
FLASH_BWD_SLACK = 64 << 20
FLASH_BWD_FIGURES = {}   # check_flash's label -> the backward's figures
# serving the token tower: SRV_B prompts of SRV_PROMPT tokens, then
# SRV_DECODE greedy decode steps. A step's logits against the last position
# of a full forward over the same tokens: both bf16 towers, the same
# weights, attention on the flash kernel (forward) or in plain torch over
# the cache (decode), matrix products of other shapes, so bf16 rounding
# apart; the int8 cache adds its quantization. Both held to SRV_TOL x
# max(1, max |logits|), the reference's bound for its int8 cache
# (tests/test_perf_features.py).
SRV_B, SRV_PROMPT, SRV_DECODE = 4, 128, 32
SRV_PROFILE = 8       # decode steps profiled after the checked ones
SRV_TOL = 0.05
# serve --retrieval on the token tower: corpora of RET_SIZES sequences of
# RET_PROMPT tokens, RET_BATCHES batches of RET_BATCH queries
RET_SIZES, RET_PROMPT, RET_BATCH, RET_BATCHES = (1024, 4096), 64, 16, 32
RET_IVF, RET_NPROBE = 64, 8


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


_LAP = [time.perf_counter()]


def lap(name):
    """Prints the host seconds since the previous lap (the script's start
    for the first) under ``name``, and the seconds since the start."""
    now = time.perf_counter()
    print(f"lap {name}: {now - _LAP[-1]:.1f} s ({now - _LAP[0]:.1f} s in "
          f"all)", flush=True)
    _LAP.append(now)


def bound_ms(bytes_moved, ops, peak=PEAK_F32):
    """Least time on the card: the bytes at the HBM rate or the operations
    at ``peak`` (by default the f32 non-tensor peak), whichever is
    longer."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cco_stats_bound_ms(n, d, moments="cross", peak=PEAK_TF32):
    """Each input read once and each output written once; FLOPs: 2Nd^2
    for cross, plus N d (d + 1) for the upper triangle (diagonal included)
    of each of the two symmetric within-view products in the full set, plus
    6Nd for the vector statistics, at the TF32 tensor-core peak, the
    fastest rate at which any route multiplies f32 inputs (``peak=PEAK_F32``
    gives the CUDA-core figure used before the kernel ran on the tensor
    cores)."""
    mats, flops = 1, 2 * n * d * d + 6 * n * d
    if moments == "full":
        mats, flops = 3, flops + 2 * n * d * (d + 1)
    return bound_ms(4 * (2 * n * d + mats * d * d + 4 * d + 1), flops, peak)


def check_cco_stats(n, d, valid, seed, moments="cross"):
    """Kernel vs plain version on pre-masked rows with ``num_valid``, as
    the engine calls it, and a second run bit-equal to the first; in the
    full set cov_f and cov_g exactly symmetric and the five cross
    statistics bit-equal to the cross set's. Returns (max_abs_err, ms,
    plain_ms, library_ms), times on the device. The yardstick is one cuBLAS
    product: zf^T zg for the cross set; for the full set z^T z with z =
    [zf, zg], which makes all three (d, d) blocks at once (and more: the
    lower blocks, no vector statistics, no masking)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = (torch.arange(n, device=dev) < valid).float()[:, None]
    zf = torch.randn(n, d, generator=gen, device=dev) * m
    zg = torch.randn(n, d, generator=gen, device=dev) * m
    nv = m.sum()
    out = cco_stats(zf, zg, nv, moments=moments)
    again = cco_stats(zf, zg, nv, moments=moments)
    torch.cuda.synchronize()
    if not all(torch.equal(out[k], again[k]) for k in out):
        fail(f"cco_stats {moments}: a second run differs at N={n} d={d}")
    plain = ref.cco_stats_ref(zf, zg, nv, moments)
    err, scale = 0.0, 0.0
    if set(out) != set(plain):
        fail(f"cco_stats {moments}: keys {sorted(out)}, expected "
             f"{sorted(plain)}")
    for k in plain:
        if out[k].shape != plain[k].shape or not out[k].is_cuda:
            fail(f"cco_stats {k}: shape {tuple(out[k].shape)} on "
                 f"{out[k].device}, expected {tuple(plain[k].shape)} on cuda")
        if not bool(torch.isfinite(out[k]).all()):
            fail(f"cco_stats {moments}: {k} is not finite at N={n} d={d}")
        err = max(err, float((out[k] - plain[k]).abs().max()))
        scale = max(scale, float(plain[k].abs().max()))
    ok = err <= TOL * (1.0 + scale)
    if moments == "full":
        for k in ("cov_f", "cov_g"):
            if not torch.equal(out[k], out[k].T):
                fail(f"cco_stats {k} is not exactly symmetric")
        cross = cco_stats(zf, zg, nv)
        if not all(torch.equal(cross[k], out[k]) for k in cross):
            fail(f"cco_stats: the full set's cross statistics differ from "
                 f"the cross set's at N={n} d={d}")
        z = torch.cat([zf, zg], 1)
        lib_ms = time_ms(lambda: torch.matmul(z.T, z))
        lib = "matmul([zf,zg]^T [zf,zg])"
    else:
        lib_ms = time_ms(lambda: torch.matmul(zf.T, zg))
        lib = "matmul(zf^T zg)"
    ms = time_ms(lambda: cco_stats(zf, zg, nv, moments=moments))
    plain_ms = time_ms(lambda: ref.cco_stats_ref(zf, zg, nv, moments))
    call_ms = eager_ms(lambda: cco_stats(zf, zg, nv, moments=moments))
    b_ms, b_by = cco_stats_bound_ms(n, d, moments)
    f32_ms, f32_by = cco_stats_bound_ms(n, d, moments, PEAK_F32)
    print(f"cco_stats moments={moments} N={n} d={d} num_valid={valid}: "
          f"max_abs_err={err:.3e} (tol {TOL:g} x (1 + {scale:.3g})) "
          f"{'ok' if ok else 'MISMATCH'}, second run bit-equal"
          f"{', symmetric, cross bit-equal' if moments == 'full' else ''}; "
          f"device ms: kernel {ms:.5f} plain {plain_ms:.5f} {lib} "
          f"{lib_ms:.5f} bound {b_ms:.5f} ({b_by}; {f32_ms:.5f}, {f32_by}, "
          f"at the f32 CUDA-core rate); eager call ms {call_ms:.5f}",
          flush=True)
    if not ok:
        fail(f"cco_stats {moments} disagrees with its plain version at "
             f"N={n} d={d}")
    return err, ms, plain_ms, lib_ms


def quant_bound_ms(k, n, two_d):
    """x and u read, out written (and the (K, n) scales read in the
    column-mapped form); 5 operations an element (divide, add, floor,
    clip, multiply)."""
    per_elem = 16 if two_d else 12
    return bound_ms(per_elem * k * n + (0 if two_d else 4 * k), 5 * k * n)


def check_quant(k, n, two_d, seed, calls=50, replays=20):
    """Kernel vs plain version, bit for bit; returns (max_abs_err, ms,
    plain_ms). The scales are per row, amax / qmax, or column-mapped: the
    row's scale times a factor in [0.5, 2) per element, as leaves of one
    payload have scales of their own. No single PyTorch call computes
    stochastic rounding, so there is no library yardstick."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(k, n, generator=gen, device=dev)
    x *= torch.logspace(-3, 1, k, device=dev)[:, None]
    u = torch.rand(k, n, generator=gen, device=dev)
    s = x.abs().amax(1) / QMAX
    if two_d:
        fac = torch.rand(k, n, generator=gen, device=dev) * 1.5 + 0.5
        s = (s[:, None] * fac).contiguous()
        del fac
    torch.cuda.reset_peak_memory_stats()
    out = quant_dequant(x, u, s, QMAX)
    torch.cuda.synchronize()
    plain = ref.quant_dequant_ref(x, u, s, QMAX)
    if out.shape != (k, n) or not out.is_cuda:
        fail(f"quant_dequant: shape {tuple(out.shape)} on {out.device}")
    err = float((out - plain).abs().max())
    equal = torch.equal(out, plain)
    del out, plain
    ms = time_ms(lambda: quant_dequant(x, u, s, QMAX), calls, replays)
    plain_ms = time_ms(lambda: ref.quant_dequant_ref(x, u, s, QMAX), calls,
                       replays)
    peak = torch.cuda.max_memory_allocated() / 2**30
    b_ms, b_by = quant_bound_ms(k, n, two_d)
    form = "column-mapped" if two_d else "per-row"
    print(f"quant_dequant {form} K={k} n={n}: max_abs_err={err:.3e} "
          f"bit-equal {equal}; device ms: kernel {ms:.5f} plain "
          f"{plain_ms:.5f} library none bound {b_ms:.5f} ({b_by}); peak "
          f"memory {peak:.2f} GiB", flush=True)
    if not equal:
        fail(f"quant_dequant {form} differs from its plain version at "
             f"K={k} n={n}")
    return err, ms, plain_ms


def segment_sum_bound_ms(k_valid, d, e):
    """Rows with an id in range read once, the (E, D) output written once,
    ids and weights read once; one multiply and one add an element of
    every row read."""
    return bound_ms(4 * (k_valid * d + e * d) + 8 * k_valid,
                    2 * k_valid * d)


def check_segment_sum(k, d, e, ids, seed, label, time_it=True,
                      weighted=True):
    """Kernel vs plain version on (k, d) unit-normal rows, ``ids`` and
    weights in [0, 1) (none, w = 1, unless ``weighted``), bit for bit,
    and kernel vs kernel on a second run;
    returns (max_abs_err, ms, plain_ms, library_ms, bound). The plain
    version reads its ranks on the host, so it is timed eagerly (CUDA
    events around back-to-back calls), not in a graph. The yardstick is
    one cuBLAS product ``W @ rows`` with W (E, K) = w_k [id_k = e], built
    outside the timed call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.randn(k, d, generator=gen, device=dev)
    w = torch.rand(k, generator=gen, device=dev) if weighted else None
    ids = ids.to(device=dev, dtype=torch.int32)
    out = segment_sum(rows, ids, e, w)
    again = segment_sum(rows, ids, e, w)
    torch.cuda.synchronize()
    plain = ref.segment_sum_ref(rows, ids, e, w)
    if out.shape != (e, d) or not out.is_cuda:
        fail(f"segment_sum {label}: shape {tuple(out.shape)} on {out.device}")
    err = float((out - plain).abs().max())
    equal, same = torch.equal(out, plain), torch.equal(out, again)
    del out, again, plain
    valid = (ids >= 0) & (ids < e)
    b_ms, b_by = segment_sum_bound_ms(int(valid.sum()), d, e)
    ms = plain_ms = lib_ms = float("nan")
    if time_it:
        onehot = (ids.long()[None, :] == torch.arange(e, device=dev)[:, None])
        wmat = onehot.to(torch.float32)
        if weighted:
            wmat = (wmat * w[None, :]).contiguous()
        ms = time_ms(lambda: segment_sum(rows, ids, e, w), 10, 5)
        plain_ms = eager_ms(lambda: ref.segment_sum_ref(rows, ids, e, w), 10)
        lib_ms = time_ms(lambda: torch.matmul(wmat, rows), 10, 5)
        del wmat
    print(f"segment_sum {label} K={k} D={d} E={e}: max_abs_err={err:.3e} "
          f"bit-equal {equal}, run-to-run equal {same}; device ms: kernel "
          f"{ms:.5f} plain {plain_ms:.5f} matmul(W, rows) {lib_ms:.5f} "
          f"bound {b_ms:.5f} ({b_by})", flush=True)
    if not (equal and same):
        fail(f"segment_sum {label} differs from its plain version or from "
             f"itself at K={k} D={d} E={e}")
    del rows
    torch.cuda.empty_cache()
    return err, ms, plain_ms, lib_ms, (b_ms, b_by)


def unit_rows(n, d, gen, dtype=torch.float32):
    """(n, d) random unit rows on the card, drawn from ``gen``."""
    x = torch.randn(n, d, generator=gen, device="cuda")
    x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
    return x if dtype == torch.float32 else x.to(dtype)


def mips_bound_ms(qn, n_valid, d, k, corpus_bytes):
    """The corpus rows read once, the queries read once, the (Q, k) scores
    and indices written once; 2 Q N d operations at the TF32 tensor-core
    peak, the fastest rate at which any route multiplies f32 inputs."""
    return bound_ms(n_valid * d * corpus_bytes + qn * d * 4 + 8 * qn * k,
                    2 * qn * n_valid * d, PEAK_TF32)


def mips_agree(q, corpus, out, plain, off=0):
    """(max |score - plain score|, index mismatches, all of them near
    ties): a mismatch is a near tie when the plain scores of the two picks
    (one sum over d each, the same order for both) lie within MIPS_TOL."""
    (v, i), (pv, pi) = out, plain
    err = float((v - pv).abs().max())
    bad = i != pi
    ties = True
    if bool(bad.any()):
        rows = bad.nonzero()[:, 0]
        c = corpus.float()

        def score(idx):
            return (q[rows].float() * c[idx[bad].long() - off]).sum(-1)
        ties = bool(((score(i) - score(pi)).abs() <= MIPS_TOL).all())
    return err, int(bad.sum()), ties


def check_mips(q, corpus, k, label, *, off=None, n_total=None, time_it=True,
               graph=(50, 20)):
    """Kernel vs plain version at one shape (scores to MIPS_TOL, indices
    equal but for near ties) and kernel vs kernel on a second run (bit for
    bit); returns (max_abs_err, ms, plain_ms, library_ms, bound) and the
    kernel's result. The kernel is timed in a CUDA graph, the plain
    version (thousands of small launches a call) with CUDA events around
    two eager calls after one, and the yardstick
    ``torch.topk(q @ c.T, k)`` (TF32 off; a bf16 corpus upcast in the call;
    for the offset form it gives local indices, one addition short of the
    kernel's) in a graph."""
    qn, d = q.shape
    n = corpus.shape[0]
    kw = {} if off is None else {"index_offset": off, "n_total": n_total}
    out = mips_topk(q, corpus, k, **kw)
    again = mips_topk(q, corpus, k, **kw)
    torch.cuda.synchronize()
    plain = ref.mips_topk_ref(q, corpus, k, **kw)
    if out[0].shape != (qn, k) or out[1].dtype != torch.int32 \
            or not out[0].is_cuda:
        fail(f"mips_topk {label}: {tuple(out[0].shape)} {out[1].dtype} on "
             f"{out[0].device}")
    err, mismatches, ties = mips_agree(q, corpus, out, plain, off or 0)
    same = torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])
    del again, plain
    valid = n if off is None else max(0, min(n, n_total - off))
    b = mips_bound_ms(qn, valid, d, k, corpus.element_size())
    ms = plain_ms = lib_ms = float("nan")
    if time_it:
        ms = time_ms(lambda: mips_topk(q, corpus, k, **kw), *graph)
        plain_ms = eager_ms(lambda: ref.mips_topk_ref(q, corpus, k, **kw),
                            2, 1)
        lib_ms = time_ms(lambda: torch.topk(q @ corpus.float().T, k),
                         *graph)
    print(f"mips_topk {label} Q={qn} N={n} d={d} k={k} "
          f"{str(corpus.dtype).replace('torch.', '')}"
          f"{'' if off is None else f' offset={off} n_total={n_total}'}: "
          f"max_abs_err={err:.3e} (tol {MIPS_TOL:g}), index mismatches "
          f"{mismatches} (all near ties: {ties}), run-to-run equal {same}; "
          f"device ms: kernel {ms:.5f} plain {plain_ms:.5f} topk(q @ c.T) "
          f"{lib_ms:.5f} bound {b[0]:.5f} ({b[1]})", flush=True)
    if not (err <= MIPS_TOL and ties and same):
        fail(f"mips_topk {label} disagrees with its plain version or with "
             f"itself")
    return (err, ms, plain_ms, lib_ms, b), out


def check_mips_laws(device):
    """Kernel vs plain version at every listed shape, then the exact laws
    inside the port: the offset form on 4 shards of a ragged corpus
    merged equals the unsharded search bit for bit, and duplicated rows go
    to the lowest index. Returns the figures of the training eval's
    shape (the search form) and of one shard (the offset form)."""
    gen = torch.Generator(device=device).manual_seed(40)
    figures = {}
    for qn, n, k, dtype, label, graph in (
            (512, 1536, MIPS_K, torch.float32, "training eval", (50, 20)),
            (64, SERVE_N, MIPS_K, torch.float32, "serving", (50, 20)),
            (64, SERVE_N, MIPS_K, torch.bfloat16, "serving", (50, 20)),
            (16, 1 << 20, MIPS_K, torch.float32, "deployed index", (5, 4)),
            (64, 1 << 20, MIPS_K, torch.float32, "deployed index", (5, 4)),
            (64, 1 << 20, MIPS_K, torch.bfloat16, "deployed index", (5, 4)),
            (1024, 65536, 32, torch.float32, "large batch", (5, 4))):
        corpus = unit_rows(n, MAIN_D, gen, dtype)
        q = unit_rows(qn, MAIN_D, gen)
        fig, _ = check_mips(q, corpus, k, label, graph=graph)
        figures.setdefault(label, fig)
        del corpus, q
        torch.cuda.empty_cache()

    # a ragged corpus: the search form at k = 1, then 4 shards of it
    n = 1_000_003
    corpus = unit_rows(n, MAIN_D, gen)
    check_mips(unit_rows(7, MAIN_D, gen), corpus, 1, "ragged", graph=(5, 4))
    q = unit_rows(16, MAIN_D, gen)
    whole = mips_topk(q, corpus, MIPS_K)
    shards = retrieval.sharded.stack_shards(corpus, 4)
    size = shards.shape[1]
    parts = []
    for s in range(4):
        fig, out = check_mips(q, shards[s], MIPS_K, f"shard {s} of 4",
                              off=s * size, n_total=n, time_it=s == 0,
                              graph=(5, 4))
        if s == 0:
            figures["shard"] = fig
        parts.append(out)
    merged = retrieval.sharded.merge_topk(
        torch.stack([v for v, _ in parts]), torch.stack([i for _, i in parts]),
        MIPS_K)
    equal = torch.equal(merged[0], whole[0]) and torch.equal(merged[1],
                                                             whole[1])
    print(f"mips_topk 4 shards of N={n} (shard_size {size}, last zero-padded)"
          f" merged vs unsharded: bit-equal {equal}", flush=True)
    if not equal:
        fail("the sharded search differs from the unsharded one")
    del corpus, shards, parts
    torch.cuda.empty_cache()

    # duplicated rows: rows [8192, 8292) repeat rows [0, 100), and each
    # query is one of them, so its best two are a tie of equal bits
    corpus = unit_rows(SERVE_N, MAIN_D, gen)
    corpus[8192:8292] = corpus[:100]
    q = corpus[:100:7].clone()
    (_, _, _, _, _), (v, i) = check_mips(q, corpus, MIPS_K, "duplicated rows",
                                         time_it=False)
    rows = torch.arange(0, 100, 7, device=device, dtype=torch.int32)
    lowest = (torch.equal(i[:, 0], rows) and torch.equal(i[:, 1], rows + 8192)
              and torch.equal(v[:, 0], v[:, 1]))
    print(f"mips_topk duplicated rows: the tie goes to the lowest index "
          f"{lowest}", flush=True)
    if not lowest:
        fail("a tie between duplicated rows did not go to the lowest index")
    return figures


def check_fold_to_edges(device, k, e):
    """``fold_to_edges`` of a stacked (K, ...) deltas tree of the
    full-width model, end to end (the leaf concatenation, the kernel and
    the split), beside the kernel alone on the concatenated rows."""
    params = dual_encoder.init_dual_encoder(
        0, get_config("resnet14-cifar"),
        get_dual_encoder_config("resnet14-cifar"), device)
    gen = torch.Generator(device=device).manual_seed(7)
    tree = utils.tree_map(
        lambda p: torch.randn((k,) + tuple(p.shape), generator=gen,
                              device=device), params)
    del params
    w = torch.rand(k, generator=gen, device=device)
    ids = (torch.arange(k, device=device) // (k // e)).to(torch.int32)
    rows = torch.cat([x.reshape(k, -1) for x in utils.tree_leaves(tree)], 1)
    folded = fold_to_edges(tree, w, ids, e)
    flat = torch.cat([x.reshape(e, -1) for x in utils.tree_leaves(folded)],
                     1)
    if not torch.equal(flat, segment_sum(rows, ids, e, w)):
        fail("fold_to_edges differs from one kernel call on its rows")
    del folded, flat
    ms = eager_ms(lambda: fold_to_edges(tree, w, ids, e), 10)
    kernel = eager_ms(lambda: segment_sum(rows, ids, e, w), 10)
    print(f"fold_to_edges deltas K={k} D={rows.shape[1]} E={e}: end to end "
          f"{ms:.5f} ms, the kernel alone {kernel:.5f} ms (eager, CUDA "
          f"events); the concatenation moves {2 * rows.numel() * 4 / 1e9:.3f}"
          f" GB", flush=True)
    del tree, rows
    torch.cuda.empty_cache()


def appendix_a(device, objective="dcco"):
    """One round of ``objective`` against one centralized step on the same
    cohort.

    The gate on parameters runs in f64: the reference's GroupNorm
    normalises each pixel over its group's channels only, and GN(32) on
    the 64-channel first stage makes groups of 2 channels, whose f32
    gradients are dominated by rounding (ROADMAP section 3); in f64 the
    identity holds to rounding. The f32 round, phase 1 through the kernel
    in the objective's moment set, is reported and gated on its loss, which
    equals the centralized loss by construction.
    """
    cfg = get_config("resnet14-cifar")
    de_cfg = get_dual_encoder_config("resnet14-cifar")
    imgs, labels = synthetic.synthetic_labeled_images(
        DATASET, 5, image_size=cfg.image_size, noise=0.5, seed=0)
    ds = pipeline.FederatedDataset.build(
        {"images": imgs}, labels, num_clients=DATASET // N_PER_CLIENT,
        samples_per_client=N_PER_CLIENT,
        partition=partition.PartitionSpec("dirichlet", alpha=0.0), seed=0)
    batch, sizes = ds.make_round_sampler(K, device)(
        torch.Generator(device=device).manual_seed(42))
    obj = get_objective(objective, **({"lam": 5.0} if objective == "dcco"
                                      else {}))
    results = {}
    for dtype in ("float64", "float32"):
        c = cfg.replace(dtype=dtype)
        params = dual_encoder.init_dual_encoder(0, c, de_cfg, device)
        apply = train.make_apply(c, de_cfg)
        opt = opt_lib.sgd(0.05)
        agg = (round_engine.make_kernel_agg_stats(obj.second_moments)
               if dtype == "float32" else None)
        p_fed, _, m_fed = fed_sim.stats_round(
            apply, params, opt.init(params), opt, batch, sizes,
            objective=obj, agg_stats_fn=agg)
        p_cent, _, m_cent = fed_sim.centralized_step(
            apply, params, opt.init(params), opt,
            fed_sim._flatten_clients(batch), objective=obj)
        torch.cuda.synchronize()
        rel = (utils.tree_max_abs_diff(p_fed, p_cent)
               / utils.tree_max_abs_diff(p_cent, params))
        lf, lc = float(m_fed.loss), float(m_cent.loss)
        results[dtype] = (rel, lf, lc)
        print(f"appendix-A {objective} {dtype} (full width, K={K} x "
              f"{N_PER_CLIENT}): |fed - centralized| / |update| = "
              f"{rel:.3e}; loss fed={lf:.6f} centralized={lc:.6f}",
              flush=True)
        del p_fed, p_cent, params
    rel64, lf64, lc64 = results["float64"]
    _, lf32, lc32 = results["float32"]
    if not (rel64 < 1e-4 and abs(lf64 - lc64) <= 1e-9 * abs(lc64)
            and abs(lf32 - lc32) <= 1e-4 * abs(lc32)):
        fail(f"one {objective} round does not equal one centralized step "
             f"(gates: f64 parameters 1e-4 of the update, f64 loss 1e-9, "
             f"f32 loss 1e-4)")


def check_flash(b, h, kvh, sq, skv, dh, dtype, label, *, causal=True,
                window=0, seed=0, dv=None, view=False, time_bwd=False,
                mem_gate=False):
    """Kernel vs plain version at one shape (v ``dv`` wide, by default
    ``dh``): the output to FLASH_TOL of its type and the row log-sum-exp
    to 2e-5 (1 + |lse|); then the backward kernel
    (``check_flash_backward``, timed with ``time_bwd``, its memory gated
    with ``mem_gate``); returns (max_abs_err, ms, plain_ms, library_ms,
    bound) of the forward. With ``view`` the operands are (B, S, H, Dh)
    tensors seen as (B, H, S, Dh), as the model hands them, read in place:
    the output and lse must equal those of their contiguous copies bit for
    bit. The bound
    takes the f32 route's operations at the TF32 peak (its products run on
    the tensor cores); the f32 CUDA-core figure is printed beside it. The
    kernel and the plain version are timed in CUDA graphs;
    the yardstick is one ``scaled_dot_product_attention(...,
    enable_gqa=True)``, causal where its top-left causal mask is the
    kernel's (Sq == Skv, no window), else with the kernel's mask passed
    in; library_ms is None where no SDPA backend takes the shapes."""
    dev = torch.device("cuda")
    dv = dh if dv is None else dv
    gen = torch.Generator(device=dev).manual_seed(seed)
    if view:
        q, k, v = (torch.randn(b, s, n, d, generator=gen, device=dev).to(
            dtype).transpose(1, 2) for s, n, d in (
                (sq, h, dh), (skv, kvh, dh), (skv, kvh, dv)))
    else:
        q = torch.randn(b, h, sq, dh, generator=gen, device=dev).to(dtype)
        k = torch.randn(b, kvh, skv, dh, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, kvh, skv, dv, generator=gen, device=dev).to(dtype)
    kw = {"causal": causal, "window": window, "scale": 1.0 / dh ** 0.5}
    out, lse = FlashAttention.apply(q, k, v, causal, window, kw["scale"])
    again = flash_attention(q, k, v, causal=causal, window=window)
    in_place = True
    if view:
        c_out, c_lse = FlashAttention.apply(q.contiguous(), k.contiguous(),
                                            v.contiguous(), causal, window,
                                            kw["scale"])
        in_place = torch.equal(out, c_out) and torch.equal(lse, c_lse)
        del c_out, c_lse
    torch.cuda.synchronize()
    plain, plain_lse = ref.flash_attention_ref(q, k, v, return_lse=True,
                                               **kw)
    if (out.shape != (b, h, sq, dv) or out.dtype != dtype
            or not out.is_cuda):
        fail(f"flash_attention {label}: {tuple(out.shape)} {out.dtype} on "
             f"{out.device}")
    err = float((out.float() - plain.float()).abs().max())
    lse_err = float(((lse - plain_lse).abs() / (1 + plain_lse.abs())).max())
    same = torch.equal(out, again)
    del again, plain, plain_lse
    check_flash_backward(q, k, v, out, lse, causal, window, kw["scale"],
                         label, seed, time_it=time_bwd, mem_gate=mem_gate)
    del lse
    valid = ref.flash_attention_mask(sq, skv, causal, window, dev)
    bnd = flash_bound_ms(q, k, v, valid)
    cores = ("" if dtype != torch.float32 else
             f"; at the f32 CUDA-core rate "
             f"{flash_bound_ms(q, k, v, valid, PEAK_F32)[0]:.5f}")
    ms = time_ms(lambda: flash_attention(q, k, v, causal=causal,
                                         window=window), 20, 10)
    plain_ms = time_ms(lambda: ref.flash_attention_ref(q, k, v, **kw), 5, 4)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if causal and window == 0 and sq == skv:
        mask = {"is_causal": True}
    else:
        mask = {"attn_mask": valid}
    try:
        lib_ms = time_ms(lambda: sdpa(q, k, v, enable_gqa=True, **mask),
                         20, 10)
    except RuntimeError as e:          # no backend takes these shapes
        print(f"sdpa at {label}: {str(e).splitlines()[0][:160]}",
              flush=True)
        lib_ms = None
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    print(f"flash_attention {label} B={b} H={h} KVH={kvh} Sq={sq} Skv={skv} "
          f"Dh={dh} Dv={dv} {str(dtype).replace('torch.', '')} "
          f"causal={causal} window={window}: max_abs_err={err:.3e} (tol "
          f"{tol:g}), lse rel err {lse_err:.3e} (tol 2e-5), run-to-run "
          f"equal {same}; device ms: kernel {ms:.5f} plain {plain_ms:.5f} "
          f"sdpa {'none' if lib_ms is None else f'{lib_ms:.5f}'} bound "
          f"{bnd[0]:.5f} ({bnd[1]}{cores})"
          + (f"; (B, S, H, Dh) views read in place, equal to their "
             f"contiguous copies bit for bit {in_place}" if view else ""),
          flush=True)
    if not (err <= tol and lse_err <= 2e-5 and same and in_place):
        fail(f"flash_attention {label} disagrees with its plain version or "
             f"with itself")
    del q, k, v, out, valid
    torch.cuda.empty_cache()
    return err, ms, plain_ms, lib_ms, bnd


def check_flash_backward(q, k, v, out, lse, causal, window, scale, label,
                         seed, *, time_it=False, mem_gate=False):
    """The backward kernel (``flash_attention._backward``: 2-3 launches)
    against its plain version (``attention_backward``) on the same q, k, v,
    output, row log-sum-exp and a random output gradient: dq, dk and dv to
    FLASH_BWD_TOL of the largest gradient, a second run bit-equal. With
    ``mem_gate`` its peak device memory above the inputs must be at most
    dq, dk, dv, delta and FLASH_BWD_SLACK; with ``time_it`` the kernel, the
    plain version and SDPA's backward (its forward outside the timed
    region) are timed. Records (max_abs_err, ms, plain_ms, library_ms,
    bound) under ``label`` in FLASH_BWD_FIGURES."""
    dev = q.device
    gen = torch.Generator(device=dev).manual_seed(seed + 1000)
    do = torch.randn(out.shape, generator=gen, device=dev).to(q.dtype)
    args = (q, k, v, out, lse, do, causal, window, scale)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = flash_mod._backward(*args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    need = (sum(x.numel() * x.element_size() for x in grads)
            + 4 * lse.numel())
    again = flash_mod._backward(*args)
    plain = flash_mod.attention_backward(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(grads, again))
    top = max(float(p.float().abs().max()) for p in plain)
    errs = [float((a.float() - p.float()).abs().max())
            for a, p in zip(grads, plain)]
    del again, plain
    tol = FLASH_BWD_TOL[q.dtype]
    bnd = flash_bwd_bound_ms(q, k, v, causal, window)
    ms = plain_ms = lib_ms = None
    if time_it:
        big = q.shape[2] >= 4096
        calls, replays = (3, 3) if big else (20, 10)
        ms = time_ms(lambda: flash_mod._backward(*args), calls, replays)
        plain_ms = time_ms(lambda: flash_mod.attention_backward(*args),
                           2 if big else 5, 3 if big else 4)
        mask = ({"is_causal": True}
                if causal and window == 0 and q.shape[2] == k.shape[2]
                else {"attn_mask": ref.flash_attention_mask(
                    q.shape[2], k.shape[2], causal, window, dev)})
        lib_ms = sdpa_backward_ms(q, k, v, mask, calls, replays)
    fmt = (lambda x: "not timed" if x is None else f"{x:.5f}")
    print(f"flash_attention backward {label}: max |kernel - plain| dq, dk, "
          f"dv {', '.join(f'{e:.3e}' for e in errs)} of max |grad| "
          f"{top:.3e} (tol {tol:g} of it), run-to-run equal {same}; peak "
          f"memory above the inputs {peak / 2 ** 20:.2f} MiB (dq, dk, dv and "
          f"delta {need / 2 ** 20:.2f} MiB"
          + (f", gate + {FLASH_BWD_SLACK >> 20} MiB" if mem_gate else "")
          + f"); device ms: kernel {fmt(ms)} plain {fmt(plain_ms)} sdpa "
          f"backward {fmt(lib_ms)} bound {bnd[0]:.5f} ({bnd[1]})",
          flush=True)
    if not (max(errs) <= tol * top and same):
        fail(f"flash_attention backward {label} disagrees with its plain "
             f"version or with itself")
    if mem_gate and peak > need + FLASH_BWD_SLACK:
        fail(f"flash_attention backward {label}: peak {peak} bytes above "
             f"the inputs, past dq, dk, dv and delta ({need}) + "
             f"{FLASH_BWD_SLACK}")
    FLASH_BWD_FIGURES[label] = (max(errs), ms, plain_ms, lib_ms, bnd)
    del grads, do


def check_flash_shapes():
    """Every shape of phase 7; returns the path shape's figures."""
    b = TOK_K * TOK_N
    figures = check_flash(b, 32, 4, TOK_S, TOK_S, 64, torch.bfloat16,
                          TOK_PATH, time_bwd=True)
    if b != 16:
        check_flash(16, 32, 4, TOK_S, TOK_S, 64, torch.bfloat16,
                    "TinyLlama, 8 clients x 2", seed=1)
    check_flash(b, 16, 8, TOK_S, TOK_S, 128, torch.bfloat16,
                "qwen3-1.7b heads (Dh 128, groups of 2)", seed=2)
    check_flash(b, 8, 2, TOK_S, TOK_S, 32, torch.float32,
                "smoke heads (Dh 32, f32)", seed=3)
    # the f32 route's one user: the smoke TinyLlama of dual_encoder_text
    # (phase 16), a 32-row query stage against a half-filled kv tile
    check_flash(8, 8, 2, 32, 32, 32, torch.float32,
                "text example (smoke TinyLlama), f32", seed=15,
                time_bwd=True)
    # the f32 route at Dh 64 and 128 (Dh 80 and MLA's dims: phases 13 and
    # 12); its backward where its accumulators flush
    check_flash(b, 32, 4, TOK_S, TOK_S, 64, torch.float32,
                "TinyLlama heads, f32", seed=12, time_bwd=True)
    check_flash(b, 16, 8, TOK_S, TOK_S, 128, torch.float32,
                "qwen3-1.7b heads (Dh 128, groups of 2), f32", seed=13)
    check_f32_flush_backward()
    for i, window in enumerate((32, 96)):
        check_flash(b, 32, 4, 256, 256, 64, torch.bfloat16,
                    f"window {window}", window=window, seed=4 + i)
    check_flash(b, 32, 4, TOK_S, TOK_S, 64, torch.bfloat16, "non-causal",
                causal=False, seed=6)
    check_flash(b, 32, 4, 64, 128, 64, torch.bfloat16, "Sq 64 of Skv 128",
                seed=7)
    check_flash(b, 32, 4, 100, 100, 64, torch.bfloat16, "ragged S 100",
                seed=8)
    check_flash(3, 8, 2, 100, 300, 32, torch.float32,
                "ragged Sq 100 of Skv 300, window 70", window=70, seed=9)
    check_flash(1, 32, 4, 4096, 4096, 64, torch.bfloat16,
                "TinyLlama heads over 4096 positions", seed=10,
                time_bwd=True, mem_gate=True)
    check_flash(b, 16, 8, 257, 257, 128, torch.bfloat16,
                "(B, S, H, Dh) views, groups of 2", seed=11, view=True)
    return figures


def check_f32_flush_backward():
    """The f32 backward where its accumulators flush into the rows' sums
    every 512 rows (csrc/flash_attention_bwd.cu), against its plain
    version on the kernel's own forward, causal: TinyLlama's heads over
    4096 positions (8 heads x 4096 query rows into each kv tile; timed
    beside SDPA's f32 backward); over 1024, where the group splits over
    blocks and each split flushes into its f32 partials before the fold;
    and Sq 64 of Skv 1100, where the query pass flushes. (The forward is
    not held here: its f32 tolerance is set for the short shapes of
    phase 7.)"""
    dev = torch.device("cuda")
    for b, kvh, sq, skv, seed, label in (
            (1, 4, 4096, 4096, 14, "TinyLlama heads over 4096 positions, "
             "f32"),
            (1, 4, 1024, 1024, 16, "TinyLlama heads over 1024 positions, "
             "the group split, f32"),
            (2, 2, 64, 1100, 17, "Sq 64 of Skv 1100, f32")):
        h = 8 * kvh
        gen = torch.Generator(device=dev).manual_seed(seed)
        q, k, v = (torch.randn(b, n, s, 64, generator=gen, device=dev)
                   for n, s in ((h, sq), (kvh, skv), (kvh, skv)))
        out, lse = FlashAttention.apply(q, k, v, True, 0, 0.125)
        check_flash_backward(q, k, v, out, lse, True, 0, 0.125, label, seed,
                             time_it=sq == 4096)
        del q, k, v, out, lse
    torch.cuda.empty_cache()


def check_flash_gradient():
    """The autograd Function's backward (the backward kernel from the
    forward kernel's row log-sum-exp) against autograd of the plain
    version, at the path's shape in f32, through a weighted sum of the
    output; held to 1e-4 of each gradient's largest magnitude (the two sum
    in other orders)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    b, h, kvh, s, dh = TOK_K * TOK_N, 32, 4, TOK_S, 64
    leaves = [torch.randn(shape, generator=gen, device=dev)
              for shape in ((b, h, s, dh), (b, kvh, s, dh), (b, kvh, s, dh))]
    w = torch.randn(b, h, s, dh, generator=gen, device=dev)
    grads = []
    for fn in (flash_attention, ref.flash_attention_ref):
        xs = [x.clone().requires_grad_() for x in leaves]
        (fn(*xs) * w).sum().backward()
        grads.append([x.grad for x in xs])
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(*grads)]
    print(f"flash_attention gradient B={b} H={h} KVH={kvh} S={s} Dh={dh} "
          f"f32: max |Function - autograd of plain| / max |grad| for q, k, "
          f"v: {', '.join(f'{e:.3e}' for e in errs)} (tol 1e-4)", flush=True)
    if not max(errs) <= 1e-4:
        fail("flash_attention's backward disagrees with autograd of its "
             "plain version")


def _reset_counts():
    for counts in (cco_stats.launches, quant_dequant.launches,
                   segment_sum.launches, mips_topk.launches,
                   flash_attention.launches):
        for key in counts:
            counts[key] = 0


def _read_counts():
    return {"cross": cco_stats.launches["cross"],
            "full": cco_stats.launches["full"],
            "per_row": quant_dequant.launches["per_row"],
            "column": quant_dequant.launches["column"],
            "fold": segment_sum.launches["fold"],
            "search": mips_topk.launches["search"],
            "offset": mips_topk.launches["offset"],
            "flash": flash_attention.launches["forward"],
            "flash_bwd": flash_attention.launches["backward"]}


def train_path(name, flags, rounds, expected, algorithm="dcco",
               d_out=MAIN_D):
    """``train --full`` through its entry point (``train.run`` with the
    engine's ``algorithm``; the CLI runs "dcco"), with every launch count
    set to 0 just before and read just after; fails unless the counts are
    ``expected`` (kernel -> launches, the others 0) and the projection is
    ``d_out`` wide. Returns the counts and the summary ``train.run``
    returns, with the peak device memory in GiB under "peak_gib"."""
    args = train.parse_args([
        "--full", "--clients-per-round", str(K), "--samples-per-client",
        str(N_PER_CLIENT), "--dataset-size", str(DATASET), "--rounds",
        str(rounds), "--eval-every", "1", *flags])
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = train.run(args, algorithm=algorithm)
    counts = _read_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    res["peak_gib"] = peak_gib
    leaves = utils.tree_leaves(res["params"])
    if len(res["history"]) != rounds or not res["loss_finite"]:
        fail(f"{name}: training losses {res['history']}")
    if not all(x.is_cuda and bool(torch.isfinite(x).all()) for x in leaves):
        fail(f"{name}: trained parameters are not finite tensors on cuda")
    width = res["params"]["proj"]["layers"][-1]["w"].shape[1]
    if width != d_out:
        fail(f"{name}: projection width {width}, expected {d_out}")
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        fail(f"{name}: kernel launches {counts} in {rounds} rounds, "
             f"expected {want}")
    steady = sorted(res["round_ms"][1:])
    print(f"train --full {' '.join(flags)} ({name}, {algorithm}): {rounds} "
          f"rounds, losses "
          f"{[float(f'{x:.6g}') for x in res['history']]}; ms/round: first "
          f"{res['round_ms'][0]:.1f}, median of the rest "
          f"{steady[len(steady) // 2]:.1f}; probe acc {res['probe']:.3f} "
          f"(per round {res['probes']}); uplink bytes {res['wire_bytes']:.6g}"
          f"; kernel launches {counts}; peak device memory {peak_gib:.2f} GiB",
          flush=True)
    if "--channel" in flags and not res["wire_bytes"] > 0:
        fail(f"{name}: no uplink bytes counted")
    if "--edges" in flags:
        print(f"{name}: uplink per hop: client->edge "
              f"{res['wire_bytes'] - res['edge_bytes']:.6g} bytes, "
              f"edge->server {res['edge_bytes']:.6g} bytes", flush=True)
        if not res["edge_bytes"] > 0:
            fail(f"{name}: no edge->server bytes counted")
    if "--async-k" in flags:
        print(f"{name}: server updates applied {res['updates']} in "
              f"{rounds} ticks", flush=True)
    if "--retrieval-eval" in flags:
        got = res["retrieval"]
        print(f"{name}: per round recall@1 {got.get('recall_at_1')}, "
              f"recall@10 {got.get('recall_at_10')}, mrr {got.get('mrr')}",
              flush=True)
        for key in ("recall_at_1", "recall_at_5", "recall_at_10", "mrr"):
            vals = got.get(key, [])
            if len(vals) != rounds or not all(0.0 <= v <= 1.0 for v in vals):
                fail(f"{name}: {key} per round {vals}, expected {rounds} "
                     f"values in [0, 1]")
    return counts, res


def release(res):
    """Drop the device state a ``train.run`` summary holds (the
    parameters and the server's state), keeping its numbers."""
    del res["params"], res["opt_state"]


def _window(label, fn, expected):
    """``fn()`` with every launch count set to 0 just before and read just
    after; fails unless the counts are ``expected`` (kernel -> launches,
    the others 0; or a function of fn's result giving them, where the
    work depends on the data). Returns fn's result and the counts."""
    _reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = _read_counts()
    if callable(expected):
        expected = expected(out)
    want = {k: expected.get(k, 0) for k in counts}
    if counts != want:
        fail(f"{label}: kernel launches {counts}, expected {want}")
    return out, counts


def serve(server, reqs):
    """One warm-up search, then each request through ``server``."""
    server.warmup()
    return [server.query(r) for r in reqs]


def serving_phase(device, params):
    """The library's serving surface on the encoder the retrieval path
    trained: ``CorpusIndex`` over SERVE_N synthetic 32x32 images (f32 and
    bf16 storage), ``QueryServer`` over SERVE_BATCHES batches of encoded
    query images (equal to ``index.search``), ``ShardedCorpusIndex`` x 4
    (equal bit for bit to the unsharded index), and ``IVFIndex`` with
    IVF_C lists (every list probed equals the exact tier but for near
    ties; recall@10 against the exact tier at IVF_NPROBE). Each surface's
    launch counts are read in a window of its own, with the comparisons
    outside it, and held exact. Returns the windows' counts."""
    cfg = get_config("resnet14-cifar")
    de_cfg = get_dual_encoder_config("resnet14-cifar")

    def embed(p, batch):
        z, _ = dual_encoder.encode(cfg, de_cfg, p, batch)
        return z

    imgs, _ = synthetic.synthetic_labeled_images(
        SERVE_N, 5, image_size=cfg.image_size, noise=0.5, seed=1)
    qimgs, _ = synthetic.synthetic_labeled_images(
        SERVE_BATCH * SERVE_BATCHES, 5, image_size=cfg.image_size,
        noise=0.5, seed=2)
    corpus = {"images": torch.as_tensor(imgs, device=device)}
    queries = retrieval.encode_corpus_chunked(
        embed, params, {"images": torch.as_tensor(qimgs, device=device)})
    del imgs, qimgs
    windows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        t0 = time.perf_counter()
        index, counts = _window(
            f"CorpusIndex.build ({name})",
            lambda: retrieval.CorpusIndex.build(embed, params, corpus,
                                                chunk=256, dtype=dtype), {})
        build_s = time.perf_counter() - t0
        server = retrieval.QueryServer(index, k=MIPS_K, batch=SERVE_BATCH)
        # odd batches are ragged: the server pads them to its batch
        reqs = [queries[b * SERVE_BATCH:(b + 1) * SERVE_BATCH - 5 * (b % 2)]
                for b in range(SERVE_BATCHES)]
        got, counts = _window(
            f"QueryServer ({name})",
            lambda: serve(server, reqs),
            {"search": 1 + SERVE_BATCHES})
        windows.append(counts)
        want = index.search(queries, MIPS_K)
        same = all(torch.equal(v, want[0][b * SERVE_BATCH:][:v.shape[0]])
                   and torch.equal(i, want[1][b * SERVE_BATCH:][:i.shape[0]])
                   for b, (v, i) in enumerate(got))
        st = server.stats()
        print(f"serving {name} index N={index.num_items} d={index.dim}: "
              f"build {build_s:.3f} s; QueryServer(batch={SERVE_BATCH}, "
              f"k={MIPS_K}) {st['batches']} batches (odd ones ragged, "
              f"{SERVE_BATCH - 5} queries), smoke reading p50 "
              f"{st['p50_us']:.1f} us; launches {counts}; equal to "
              f"index.search {same}", flush=True)
        if not same:
            fail(f"QueryServer differs from index.search ({name})")
        sharded = retrieval.ShardedCorpusIndex.from_index(index, 4)
        a, counts = _window(f"ShardedCorpusIndex x 4 ({name})",
                            lambda: sharded.search(queries, MIPS_K),
                            {"offset": 4})
        windows.append(counts)
        equal = torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
        print(f"serving {name}: ShardedCorpusIndex x 4 (shard_size "
              f"{sharded.shard_size}) equals the unsharded index bit for bit "
              f"over {queries.shape[0]} queries: {equal}; launches {counts}",
              flush=True)
        if not equal:
            fail(f"ShardedCorpusIndex differs from CorpusIndex ({name})")
        if dtype == torch.float32:
            windows.append(check_ivf(index, queries))
        del index, sharded, server, want, a
    return windows


def serving_rate(device):
    """``QueryServer(batch=SERVE_BATCH, k=MIPS_K)`` over a deployed index
    of RATE_N random unit rows from the seed (f32 and bf16 storage):
    RATE_BATCHES full batches of random unit queries back to back, with
    nothing but the server inside the window, then the served results
    held to one ``index.search`` of every query. Prints p50, p99, qps and
    qps_serial; returns the windows' counts."""
    gen = torch.Generator(device=device).manual_seed(50)
    queries = unit_rows(SERVE_BATCH * RATE_BATCHES, MAIN_D, gen)
    reqs = queries.split(SERVE_BATCH)
    windows = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        index = retrieval.CorpusIndex(unit_rows(RATE_N, MAIN_D, gen, dtype))
        server = retrieval.QueryServer(index, k=MIPS_K, batch=SERVE_BATCH)
        got, counts = _window(
            f"QueryServer over {RATE_N} rows ({name})",
            lambda: serve(server, reqs),
            {"search": 1 + RATE_BATCHES})
        windows.append(counts)
        want = index.search(queries, MIPS_K)
        same = (torch.equal(torch.cat([v for v, _ in got]), want[0])
                and torch.equal(torch.cat([i for _, i in got]), want[1]))
        st = server.stats()
        print(f"serving rate {name} index N={index.num_items} "
              f"d={index.dim}: QueryServer(batch={SERVE_BATCH}, k={MIPS_K}) "
              f"{st['batches']} batches back to back: p50 "
              f"{st['p50_us']:.1f} us, p99 {st['p99_us']:.1f} us, qps "
              f"{st['qps']:.1f}, qps_serial {st['qps_serial']:.1f}; "
              f"launches {counts}; equal to index.search {same}", flush=True)
        if not same:
            fail(f"QueryServer over {RATE_N} rows differs from index.search "
                 f"({name})")
        del index, server, got, want
        torch.cuda.empty_cache()
    return windows


def check_ivf(index, queries):
    """``IVFIndex`` with IVF_C lists over ``index``: k-means through the
    segment-sum kernel (sums and counts in each of 8 iterations, read in
    a window around the build alone), every list probed against the exact
    tier, and recall@10 at IVF_NPROBE. Returns the build's counts."""
    t0 = time.perf_counter()
    ivf, counts = _window(
        "IVFIndex.from_index",
        lambda: retrieval.IVFIndex.from_index(index, num_centroids=IVF_C,
                                              nprobe=IVF_NPROBE),
        {"fold": 2 * 8})
    build_s = time.perf_counter() - t0
    mismatches, ties, hits = 0, True, 0
    batches = queries.split(SERVE_BATCH)
    for qb in batches[:4]:
        exact = ivf.search_exact(qb, MIPS_K)
        full = ivf.search(qb, MIPS_K, nprobe=IVF_C)
        _, bad, near = mips_agree(qb, index.embeddings, full, exact)
        mismatches, ties = mismatches + bad, ties and near
    for qb in batches[:8]:
        exact = ivf.search_exact(qb, MIPS_K)[1]
        approx = ivf.search(qb, MIPS_K)[1]
        hits += int((approx[:, :, None] == exact[:, None, :]).any(-1).sum())
    recall = hits / (8 * SERVE_BATCH * MIPS_K)
    print(f"IVF C={IVF_C} (list length {ivf.list_len}, fill {ivf.fill:.3f}) "
          f"built in {build_s:.3f} s with launches {counts}; "
          f"nprobe=C vs the exact tier on {4 * SERVE_BATCH} queries: index "
          f"mismatches {mismatches} (all near ties: {ties}); recall@10 "
          f"against the exact tier at nprobe={IVF_NPROBE}: {recall:.4f}",
          flush=True)
    if not ties:
        fail("IVF with every list probed differs from the exact tier")
    return counts


def fedavg_paths():
    """The FedAvg baselines and a server strategy on the ResNet, then the
    Table-1-style probe line over the same PATH_ROUNDS rounds and cohorts
    (every path samples from seed 0). Returns the paths' launch counts."""
    tree = ["--edges", "8", "--channel", "int8", "--edge-channel", "dense"]
    paths = [
        ("fedavg_cco", [], "fedavg_cco", {}),
        ("fedavg_contrastive", [], "fedavg_contrastive", {}),
        ("fedavg_byol", [], "fedavg_byol", {}),
        # the deltas are the only uplink: one column quantize a round
        ("fedavg_contrastive over int8", ["--channel", "int8",
                                          "--quant-kernel", "fused"],
         "fedavg_contrastive", {"column": PATH_ROUNDS}),
        # begin_round's per-edge mass and the deltas fold; the int8 client
        # hop quantizes the deltas
        ("fedavg_cco hierarchical", tree, "fedavg_cco",
         {"fold": 2 * PATH_ROUNDS, "column": PATH_ROUNDS}),
        ("dcco fedadam", ["--server-opt", "fedadam"], "dcco",
         {"cross": PATH_ROUNDS}),
        ("dcco", ["--stats-kernel", "fused"], "dcco",
         {"cross": PATH_ROUNDS}),
        ("centralized", [], "centralized", {})]
    table = ("dcco", "fedavg_cco", "fedavg_contrastive", "fedavg_byol",
             "centralized")
    probes, counts = {}, []
    for name, flags, algorithm, expected in paths:
        c, res = train_path(name, flags, PATH_ROUNDS, expected, algorithm)
        counts.append(c)
        if name in table:
            probes[name] = res["probe"]
        del res
        gc.collect()
        torch.cuda.empty_cache()
    print(f"table-1 probe after {PATH_ROUNDS} rounds on the same cohorts "
          f"(full-width ResNet-14, K={K} x {N_PER_CLIENT}, seed 0; random "
          f"init, not gated): "
          + ", ".join(f"{k}={probes[k]:.4f}" for k in table), flush=True)
    return counts


MU = "0.01"            # FedProx's coefficient on the drift paths
# client lr of the paths with two local steps. D-CCO's phase-2 gradients
# are ~1e6 at init, so plain-GD local steps diverge at the CLI's 1.0 (the
# reference too: tests/test_torch_drift.py). tools/halve_client_lr.py on
# the card (PERF.md) found the first rate at which 3 rounds stay finite
# to vary across seeds 0-2 and repeats (D-CCO SCAFFOLD 2^-23..2^-25,
# FedProx 2^-12, and 2^-14 went NaN once; FedAvg+CCO SCAFFOLD 2^-6..2^-7;
# token FedProx 2^-2), so each path runs 8x below the lowest rate found.
# The paths with one local step keep 1.0.
LR_DCCO_LOCAL2 = repr(2.0 ** -28)
LR_FEDAVG_SCAFFOLD = repr(2.0 ** -10)
TOK_PROX_LR = repr(2.0 ** -5)


def variate_share(name, flags, res, rounds):
    """Print the SCAFFOLD variate deltas' share of a path's uplink: one
    parameter-sized payload a client (and, through the tree, a dense one
    an edge) each round, from the shapes, as the channel counts them."""
    if "--channel" not in flags:
        print(f"{name}: variate uplink 0 bytes (no channel: the variate "
              f"average is a tensordot, as the update's)", flush=True)
        return
    params = res["params"]
    client = comm.get_channel(flags[flags.index("--channel") + 1])
    per_round = K * client.payload_bytes(params)
    if "--edges" in flags:
        per_round += (int(flags[flags.index("--edges") + 1])
                      * comm.get_channel("dense").payload_bytes(params))
    share = per_round * rounds / res["wire_bytes"]
    print(f"{name}: variate uplink {per_round * rounds:.6g} of "
          f"{res['wire_bytes']:.6g} bytes ({100 * share:.2f}%)", flush=True)
    if not 0.0 < share < 1.0:
        fail(f"{name}: variate share {share} of the uplink")


def check_bf16_encodings(device):
    """The bf16 path's contract at full width on one 64 x 2 cohort: the
    encoder cast to bf16 gives f32 encodings (the dual encoder's output,
    as the reference's) that differ from the f32 encoder's by bf16
    rounding, and the phase-1 aggregate over them in ``cco_stats`` is f32
    and finite, with f32 master parameters untouched."""
    cfg = get_config("resnet14-cifar")
    de = get_dual_encoder_config("resnet14-cifar")
    params = dual_encoder.init_dual_encoder(0, cfg, de, device)
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.rand((MAIN_N, 32, 32, 3), generator=gen, device=device)
    batch = {"v1": x, "v2": x.flip(2)}
    apply = train.make_apply(cfg, de)
    with torch.no_grad():
        zf32, _ = apply(params, batch)
        zf, zg = round_engine.cast_encoder_apply(apply, "bfloat16")(params,
                                                                    batch)
        agg = round_engine.make_kernel_agg_stats()(
            zf, zg, torch.ones(MAIN_N, device=device))
    torch.cuda.synchronize()
    rel = float(torch.linalg.norm(zf - zf32) / torch.linalg.norm(zf32))
    masters = all(t.dtype == torch.float32
                  for t in utils.tree_leaves(params))
    ok = (zf.dtype == torch.float32 and 0.0 < rel < 0.25 and masters
          and all(v.dtype == torch.float32 and bool(torch.isfinite(v).all())
                  for v in agg.values()))
    dtypes = sorted({str(v.dtype) for v in agg.values()})
    print(f"bf16 compute at full width: encodings {zf.dtype} entering "
          f"cco_stats, |z_bf16 - z_f32| / |z_f32| = {rel:.3e}, aggregate "
          f"statistics {dtypes}, master params f32 {masters}", flush=True)
    if not ok:
        fail("bf16 compute: the encodings or statistics are not f32, or the "
             "bf16 tower did not run")


def drift_paths(device):
    """FedProx, SCAFFOLD (flat, over int8, through the tree, buffered,
    FedAvg) and bf16 compute on the ResNet, PATH_ROUNDS rounds each from
    seed 0, beside one D-CCO run in the same call. Returns the paths'
    launch counts."""
    p = PATH_ROUNDS
    tree = ["--edges", "8", "--channel", "int8", "--edge-channel", "dense"]
    def local2(lr):
        return ["--local-steps", "2", "--client-lr", lr]

    paths = [
        ("dcco fedprox", ["--fedprox-mu", MU, *local2(LR_DCCO_LOCAL2),
                          "--stats-kernel", "fused"], "dcco", {"cross": p}),
        ("dcco scaffold", ["--scaffold", *local2(LR_DCCO_LOCAL2),
                           "--stats-kernel", "fused"], "dcco", {"cross": p}),
        # the statistics, the deltas and the variate deltas
        ("dcco scaffold over int8", ["--scaffold", "--channel", "int8",
                                     "--quant-kernel", "fused"], "dcco",
         {"column": 3 * p}),
        # the per-edge mass and the three payloads' folds
        ("dcco scaffold hierarchical", ["--scaffold", *tree], "dcco",
         {"fold": 4 * p, "column": 3 * p}),
        # the variate average is a tensordot: the ring's two folds only
        ("buffered scaffold", ["--scaffold", "--async-k", "32",
                               "--latency-tail", "1.0", "--staleness",
                               "poly"], "dcco", {"fold": 2 * p}),
        ("fedavg_cco scaffold", ["--scaffold", *local2(LR_FEDAVG_SCAFFOLD)],
         "fedavg_cco", {}),
        ("dcco bf16", ["--compute-dtype", "bfloat16", "--stats-kernel",
                       "fused"], "dcco", {"cross": p})]
    counts = []
    for name, flags, algorithm, expected in paths:
        c, res = train_path(name, flags, p, expected, algorithm)
        counts.append(c)
        if not all(x.dtype == torch.float32
                   for x in utils.tree_leaves(res["params"])):
            fail(f"{name}: trained parameters are not f32")
        if "--scaffold" in flags:
            variate_share(name, flags, res, p)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    check_bf16_encodings(device)
    return counts


def _forward_logits(cfg, tower, tokens):
    """Last-position logits of a full forward (no cache)."""
    with torch.no_grad():
        h = transformer.forward(cfg, tower, tokens)
        return transformer.logits_from_hidden(cfg, tower, h[:, -1])


def profile_decode(cfg, tower, prompt, kv, steps=SRV_PROFILE):
    """``steps`` greedy decode steps after a prefill and one warm-up step,
    timed on the host clock unprofiled, then again under
    ``torch.profiler``: the device's busy time (the union of the device
    records' intervals, as ``launch/profile_round.py`` reads it) over the
    profiled wall, the device records a step and the kernels that took
    the most device time."""
    c = cfg.replace(kv_cache_dtype=kv)
    prefill = steps_lib.make_prefill_step(c, prompt.shape[1] + 2 * steps + 2)
    step = steps_lib.make_serve_step(c)
    _, cache = prefill(tower, {"tokens": prompt})
    tok = prompt[:, -1:]

    def decode():
        nonlocal cache, tok
        for _ in range(steps):
            logits, cache = step(tower, cache, {"tokens": tok})
            tok = torch.argmax(logits, -1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()

    _, cache = step(tower, cache, {"tokens": tok})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    decode()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        decode()
        prof_ms = (time.perf_counter() - t0) * 1e3 / steps
    records = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if getattr(e, "device_type", None) == DeviceType.CUDA]
    kernels, union_us, summed_us, dropped = device_time(records)
    if not kernels:
        print(f"decode profile ({kv} KV cache): no device records, device "
              f"busy share not measured", flush=True)
        return
    busy = union_us / 1e3 / steps
    top = sorted(kernels, key=lambda x: -x[2])[:4]
    print(f"decode profile ({kv} KV cache, {steps} steps x {prompt.shape[0]}"
          f"): wall {wall:.3f} ms/token unprofiled, {prof_ms:.3f} profiled; "
          f"device busy {busy:.3f} ms/token = {100 * busy / prof_ms:.1f}% "
          f"of the profiled wall (union of intervals; summed "
          f"{summed_us / 1e3 / steps:.3f}); "
          f"{(len(records) - dropped) / steps:.0f} device records a step; "
          f"top kernels (ms/token, count/token): " + "; ".join(
              f"{name[:48]} {us / 1e3 / steps:.4f} {count / steps:.0f}"
              for name, count, us in top), flush=True)


def serve_generate(device, cfg, tower):
    """Prefill and greedy decode through ``serve.generate`` with the
    model-dtype and the int8 cache, each in a window of its own; every
    step held to a full forward, the int8 steps to the model-dtype ones
    while the tokens agree. Returns the windows' counts."""
    gen = torch.Generator().manual_seed(0)
    prompt = torch.randint(0, cfg.vocab_size, (SRV_B, SRV_PROMPT),
                           generator=gen, dtype=torch.int32).to(device)
    serve_cli.generate(cfg, tower, prompt[:, :16], 2)     # cuBLAS warm-up
    windows, runs = [], {}
    for kv in ("model", "int8"):
        c = cfg.replace(kv_cache_dtype=kv)
        torch.cuda.reset_peak_memory_stats()
        out, counts = _window(
            f"serve prefill + decode ({kv} cache)",
            lambda: serve_cli.generate(c, tower, prompt, SRV_DECODE + 1),
            {"flash": TOK_LAYERS})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        windows.append(counts)
        errs, scale = [], 1.0
        for j, logits in enumerate(out["logits"]):
            seq = torch.cat([prompt, out["tokens"][:, :j]], dim=1)
            want = _forward_logits(cfg, tower, seq)
            scale = max(scale, float(want.abs().max()))
            errs.append(float((logits - want).abs().max()))
        cache_mib = sum(x.numel() * x.element_size() for x in
                        utils.tree_leaves(out["cache"])) / 2 ** 20
        runs[kv] = out
        print(f"serve tinyllama-1.1b ({kv} KV cache, {cache_mib:.1f} MiB): "
              f"prefill {SRV_B}x{SRV_PROMPT} {out['prefill_ms']:.3f} ms, "
              f"decode {out['decode_ms']:.3f} ms/token over {SRV_DECODE} "
              f"steps x {SRV_B}; peak device memory {peak:.2f} GiB; "
              f"launches {counts}; |logits - full forward| worst "
              f"{max(errs):.4e} (prefill {errs[0]:.4e}, last step "
              f"{errs[-1]:.4e}), tol {SRV_TOL * scale:.4e} "
              f"(= {SRV_TOL} x {scale:.3f})", flush=True)
        if not (out["tokens"].shape == (SRV_B, SRV_DECODE + 1)
                and max(errs) <= SRV_TOL * scale):
            fail(f"serving with the {kv} cache disagrees with a full "
                 f"forward")
    m, q = runs["model"], runs["int8"]
    agree = 0
    while (agree < SRV_DECODE + 1 and torch.equal(
            m["tokens"][:, :agree], q["tokens"][:, :agree])):
        agree += 1
    diffs = [float((a - b).abs().max()) for a, b in
             zip(m["logits"][:agree], q["logits"][:agree])]
    scale = max(1.0, max(float(x.abs().max()) for x in m["logits"]))
    print(f"serve int8 vs model-dtype KV cache: {agree} of {SRV_DECODE + 1} "
          f"steps on the same tokens, |logits| difference worst "
          f"{max(diffs):.4e} (tol {SRV_TOL * scale:.4e}); greedy tokens "
          f"equal throughout: {torch.equal(m['tokens'], q['tokens'])}",
          flush=True)
    if not max(diffs) <= SRV_TOL * scale:
        fail("the int8 KV cache departs from the model-dtype cache")
    for kv in ("model", "int8"):
        profile_decode(cfg, tower, prompt, kv)
    return windows


def check_retrieval_kernels(results):
    """The kernels of ``serve --retrieval`` against their plain versions
    at the shapes it gives them: flash at an index-build chunk (256 x 64
    tokens) and at the queries' encode (RET_BATCH x RET_BATCHES x 64);
    the k-means sums (N, 64) and counts (N, 1) into RET_IVF lists; for
    each corpus the MIPS search of one QueryServer batch and of every
    query, and each shard's offset search of one batch."""
    check_flash(256, 32, 4, RET_PROMPT, RET_PROMPT, 64, torch.bfloat16,
                "serve --retrieval index-build chunk", seed=50)
    check_flash(RET_BATCH * RET_BATCHES, 32, 4, RET_PROMPT, RET_PROMPT, 64,
                torch.bfloat16, "serve --retrieval query encode", seed=51)
    for i, n in enumerate(RET_SIZES):
        ids = torch.randint(0, RET_IVF, (n,), generator=torch.Generator(
            device="cuda").manual_seed(52 + i), device="cuda")
        for d, what in ((64, "sums"), (1, "counts")):
            check_segment_sum(n, d, RET_IVF, ids, 54 + i,
                              f"k-means {what}, unweighted",
                              time_it=False, weighted=False)
        exact = results["exact"][i]["index"]
        q = results["exact"][i]["query_embeddings"]
        check_mips(q[:RET_BATCH], exact.embeddings, 10,
                   "serve --retrieval exact, one batch", time_it=False)
        want = exact.search(q, 10)
        plain = ref.mips_topk_ref(q, exact.embeddings, 10)
        err, bad, ties = mips_agree(q, exact.embeddings, want, plain)
        print(f"serve --retrieval exact N={n}, all {q.shape[0]} queries: "
              f"max_abs_err={err:.3e} (tol {MIPS_TOL:g}) against the plain "
              f"version, index mismatches {bad} (all near ties: {ties})",
              flush=True)
        if not (err <= MIPS_TOL and ties):
            fail(f"serve --retrieval exact search disagrees with its plain "
                 f"version at N={n}")
        sharded = results["sharded x2"][i]["index"]
        for j in range(sharded.num_shards):
            check_mips(q[:RET_BATCH], sharded.shards[j], 10,
                       f"serve --retrieval shard {j} of 2", time_it=False,
                       off=j * sharded.shard_size, n_total=n)


def serve_retrieval(ckpt):
    """``serve.run_retrieval`` with ``--ckpt`` over token corpora, in its
    three tiers, each a window of its own with exact launches; the kernels
    held to their plain versions at the tiers' shapes, the tiers' results
    to the exact tier's. Returns the windows' counts."""
    chunks = sum(-(-n // min(256, n)) for n in RET_SIZES)
    flash = TOK_LAYERS * (1 + chunks)     # the queries' encode and the chunks
    served = 1 + RET_BATCHES              # the warm-up and the batches
    base = ["--retrieval", "--full", "--corpus-sizes",
            ",".join(map(str, RET_SIZES)), "--prompt-len", str(RET_PROMPT),
            "--batch", str(RET_BATCH), "--serve-batches", str(RET_BATCHES),
            "--ckpt", ckpt]
    tiers = [("exact", [], {"search": len(RET_SIZES) * served}),
             ("sharded x2", ["--shards", "2"],
              {"offset": 2 * len(RET_SIZES) * served}),
             # k-means: sums and counts in each of 8 iterations
             (f"ivf C={RET_IVF}", ["--ivf", str(RET_IVF), "--nprobe",
                                   str(RET_NPROBE)],
              {"fold": 2 * 8 * len(RET_SIZES)})]
    windows, results = [], {}
    for name, flags, expected in tiers:
        args = serve_cli.build_parser().parse_args(base + flags)
        res, counts = _window(f"serve --retrieval {name}",
                              lambda: serve_cli.run_retrieval(args),
                              {"flash": flash, **expected})
        windows.append(counts)
        results[name] = res
        for r in res:
            print(f"serve --retrieval {name} tinyllama-1.1b N={r['n']} "
                  f"S={RET_PROMPT} d={r['index'].dim}: build "
                  f"{r['build_s']:.3f} s; QueryServer(batch={RET_BATCH}, "
                  f"k=10) {r['batches']} batches p50 {r['p50_us']:.1f} us, "
                  f"p99 {r['p99_us']:.1f} us, qps {r['qps']:.1f}, "
                  f"qps_serial {r['qps_serial']:.1f}; launches {counts}",
                  flush=True)
    check_retrieval_kernels(results)
    for i, n in enumerate(RET_SIZES):
        exact = results["exact"][i]["index"]
        q = results["exact"][i]["query_embeddings"]
        want = exact.search(q, 10)
        got = results["sharded x2"][i]["index"].search(q, 10)
        ivf = results[f"ivf C={RET_IVF}"][i]["index"]
        full = ivf.search(q, 10, nprobe=ivf.num_centroids)
        _, bad, ties = mips_agree(q, exact.embeddings, full, want)
        approx = ivf.search(q, 10)[1]
        recall = float((approx[:, :, None] == want[1][:, None, :]).any(-1)
                       .float().mean())
        equal = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        print(f"serve --retrieval N={n}: 2 shards equal the exact tier bit "
              f"for bit {equal}; IVF with every list probed: index "
              f"mismatches {bad} (all near ties: {ties}); IVF recall@10 at "
              f"nprobe={RET_NPROBE}: {recall:.4f}", flush=True)
        if not (equal and ties):
            fail(f"serve --retrieval tiers disagree at N={n}")
    return windows, results["exact"][-1]


def check_index_files(exact):
    """An f32 and a bf16 CorpusIndex saved and loaded on the card: the
    embeddings and the searches equal before and after."""
    q = exact["query_embeddings"]
    with tempfile.TemporaryDirectory() as d:
        for dtype in (torch.float32, torch.bfloat16):
            idx = retrieval.CorpusIndex(exact["index"].embeddings.to(dtype))
            path = f"{d}/index.msgpack"
            idx.save(path)
            back = retrieval.CorpusIndex.load(path)
            a, b = idx.search(q, 10), back.search(q, 10)
            same = (back.embeddings.is_cuda
                    and torch.equal(back.embeddings, idx.embeddings)
                    and torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]))
            print(f"CorpusIndex {str(dtype).replace('torch.', '')} "
                  f"N={idx.num_items} saved and loaded: searches equal "
                  f"{same}", flush=True)
            if not same:
                fail(f"CorpusIndex ({dtype}) changed through save/load")


def _same_bits(a, b):
    la, lb = utils.tree_leaves(a), utils.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def serving_phase_tokens(device):
    """Phase 10's serving half on the full-width TinyLlama-1.1B tower.
    Returns the windows' counts."""
    cfg = get_config(TOK_ARCH)
    de = DualEncoderConfig(proj_dims=(64, 64))
    params = dual_encoder.init_dual_encoder(0, cfg, de, device)
    windows = serve_generate(device, cfg, params["tower"])
    with tempfile.TemporaryDirectory() as d:
        path = f"{d}/tinyllama.msgpack"
        t0 = time.perf_counter()
        save_checkpoint(path, {"params": params}, step=0)
        t_save = time.perf_counter() - t0
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        blob, _ = restore_checkpoint(path, {"params": params})
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        restored = blob["params"]
        same = _same_bits(restored, params)
        dtypes = sorted({str(x.dtype) for x in utils.tree_leaves(restored)})
        print(f"checkpoint of the full-width tinyllama-1.1b dual encoder: "
              f"{size / 2 ** 30:.3f} GiB, saved in {t_save:.2f} s, restored "
              f"to the card in {t_load:.2f} s, leaves {dtypes}, equal bit "
              f"for bit {same}", flush=True)
        if not same:
            fail("the tinyllama checkpoint did not restore bit for bit")
        del params, blob, restored
        gc.collect()
        torch.cuda.empty_cache()
        more, exact = serve_retrieval(path)
    check_index_files(exact)
    return windows + more


def checkpoint_resume(device):
    """The ResNet's D-CCO with SCAFFOLD through ``train --ckpt-dir
    --ckpt-every 2`` over 4 rounds, every blob the engine writes kept
    beside what it saved; round 2's restored bit for bit; ``--resume``
    from it held to the uninterrupted run within the distance between two
    uninterrupted runs. Returns the runs' counts."""
    real_save, saved = round_engine.save_checkpoint, {}

    def keep(path, tree, step):
        real_save(path, tree, step)
        shutil.copy(path, f"{path}.{step}")
        saved[step] = (tree, utils.tree_map(lambda x: x.clone(), tree))

    flags = ["--scaffold", "--stats-kernel", "fused"]
    counts = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    round_engine.save_checkpoint = keep
    try:
        with tempfile.TemporaryDirectory() as d:
            c, full = train_path("dcco scaffold, checkpointed",
                                 [*flags, "--ckpt-dir", d, "--ckpt-every",
                                  "2"], 4, {"cross": 4})
            counts.append(c)
            round_engine.save_checkpoint = real_save
            path = f"{d}/resnet14-cifar.msgpack.2"
            like, want = saved[2]
            blob, step = restore_checkpoint(path, like)
            same = step == 2 and sorted(blob) == ["drift", "opt",
                                                  "params"] and \
                _same_bits(blob, want)
            print(f"checkpoint of round 2 (params, Adam state, SCAFFOLD "
                  f"variates: {len(utils.tree_leaves(blob))} leaves, "
                  f"{Path(path).stat().st_size / 2 ** 20:.1f} MiB) restored "
                  f"equal to what the engine saved, bit for bit: {same}",
                  flush=True)
            if not same:
                fail("the engine's checkpoint did not restore bit for bit")
            args = train.parse_args([
                "--full", "--clients-per-round", str(K),
                "--samples-per-client", str(N_PER_CLIENT), "--dataset-size",
                str(DATASET), "--rounds", "4", "--eval-every", "1", *flags,
                "--ckpt-dir", d, "--ckpt-every", "0", "--resume", path])
            resumed, c = _window("dcco scaffold, resumed at round 2",
                                 lambda: train.run(args), {"cross": 2})
            counts.append(c)
        c, again = train_path("dcco scaffold, uninterrupted again", flags,
                              4, {"cross": 4})
        counts.append(c)
    finally:
        round_engine.save_checkpoint = real_save
        torch.backends.cudnn.deterministic = deterministic
    d_resume = utils.tree_max_abs_diff(resumed["params"], full["params"])
    d_repeat = utils.tree_max_abs_diff(again["params"], full["params"])
    print(f"resume from round 2 of 4: history {resumed['history']} (the "
          f"uninterrupted run's rounds 3-4: {full['history'][2:]}); max "
          f"|params resumed - uninterrupted| = {d_resume:.4e}, max |two "
          f"uninterrupted runs| = {d_repeat:.4e}", flush=True)
    if not (d_resume <= d_repeat and len(resumed["history"]) == 2):
        fail("resuming from the checkpoint departs from the uninterrupted "
             "run by more than two uninterrupted runs differ")
    return counts


# phase 11: streamed cohorts and the fused and protocol training modes.
# STREAM_K clients a round streamed in chunks of STREAM_CHUNK (one edge of
# the 8-edge tree a chunk); the equivalence round at the main paths' K in
# chunks of EQ_CHUNK; the token tower at TOK_STREAM_KS clients in chunks of
# TOK_CHUNK; the fused token step over FUSED_K clients in FUSED_MICRO
# microbatches, and its gradient check on GRAD_B sequences. The token
# tower's paths and the streamed D-CCO path without a kernel run
# TOK_STREAM_ROUNDS rounds, the rest PATH_ROUNDS.
STREAM_K, STREAM_CHUNK, EQ_CHUNK = 512, 64, 16
TOK_STREAM_KS, TOK_CHUNK, TOK_STREAM_ROUNDS = (8, 16), 4, 2
FUSED_K, FUSED_MICRO, GRAD_B = 16, 4, 8
# streamed vs materialized at full width, one lossless round, server SGD:
# max |p_streamed - p_materialized| / max |p_materialized - p_0| <=
# STREAM_TOL[dtype]. Only the grouping of the Eq.-3 sums differs, and the
# batch shapes the convolutions and the vmapped phase 2 see (so cuDNN
# picks other algorithms); a protocol fault moves the parameters by O(1)
# of the update. D-CCO's first round at random init amplifies rounding by
# ~1e4 (the f32 round read 7.7e-3 on the card), so the identity is gated
# in f64, where it holds to rounding; the f32 round is gated only against
# a fault. The materialized f32 round through the statistics kernel
# against the per-client average is printed beside it as a yardstick.
STREAM_TOL, EQ_LR = {"float64": 1e-5, "float32": 1e-1}, 1e-5
# the fused token step's gradient, micro FUSED_MICRO against micro 1 on
# one batch: ||g_M - g_1|| / ||g_1|| over all leaves <= GRAD_TOL. Both run
# the bf16 tower (2^-8 relative rounding of every activation and product)
# on other batch shapes, and the single step's gradient is bf16 where the
# microbatched one is averaged in f32.
GRAD_TOL = 5e-2
# flash-attention forwards of the token tower (2 views x 22 layers):
# a streamed chunk runs phase 1 (44) and phase 2 with the chunk's clients
# folded into one launch a layer and view (44); a fused single step 44; a
# microbatch of the microbatched step 44 in phase 1, then 44 in phase 2's
# checkpointed forward and 44 again in its recompute for the backward.
# Backward calls: 44 a chunk's phase 2, a single step, a microbatch.
FLASH_CHUNK = 2 * 2 * TOK_LAYERS
FLASH_MICRO = 3 * 2 * TOK_LAYERS
FLASH_BWD = 2 * TOK_LAYERS


def streamed_equivalence(device):
    """One lossless round of the full-width ResNet at K clients, streamed
    in chunks of EQ_CHUNK against materialized, from the same round
    generator and parameters, server SGD, in f64 and in f32: the sampled
    cohorts equal bit for bit, the parameters within STREAM_TOL of the
    update. Returns the windows' counts."""
    cfg = get_config("resnet14-cifar")
    args = train.parse_args([
        "--full", "--clients-per-round", str(K), "--samples-per-client",
        str(N_PER_CLIENT), "--dataset-size", str(DATASET)])
    de_cfg = DualEncoderConfig(
        proj_dims=get_dual_encoder_config("resnet14-cifar").proj_dims,
        lambda_cco=args.lam)
    ds, _ = train.build_dataset(cfg, args)
    mat = ds.make_round_sampler(K, device)
    stream = ds.make_streaming_sampler(K, EQ_CHUNK, device)
    round_seed = 0              # round 0 of seed 0, as engine.run(.., 0, 1)
    batch, sizes = mat(utils.generator(round_seed, device))
    state = stream.prepare(utils.generator(round_seed, device))
    chunks = [stream.sample_chunk(state, c) for c in range(stream.num_chunks)]
    same = all(torch.equal(torch.cat([b[v] for b, _ in chunks]), batch[v])
               for v in ("v1", "v2")) and torch.equal(
                   torch.cat([z for _, z in chunks]), sizes)
    print(f"streamed sampler (K={K}, chunks of {EQ_CHUNK}): its chunks "
          f"concatenated equal the materialized sampler's cohort bit for "
          f"bit: {same}", flush=True)
    if not same:
        fail("the streamed chunks are not the materialized cohort")
    del batch, sizes, state, chunks
    opt = opt_lib.sgd(EQ_LR)
    base = round_engine.EngineConfig(lam=args.lam, chunk_rounds=1)
    streamed = f"streamed in chunks of {EQ_CHUNK}"
    counts, dist = [], {}
    for dtype in ("float64", "float32"):
        c_dt = cfg.replace(dtype=dtype)
        p0 = dual_encoder.init_dual_encoder(0, c_dt, de_cfg, device)
        apply = train.make_apply(c_dt, de_cfg)
        runs = [("materialized, per-client phase 1",
                 base._replace(stats_kernel="off"), mat, {}),
                (streamed, base._replace(cohort_chunk=EQ_CHUNK), stream, {})]
        if dtype == "float32":
            runs.insert(1, ("materialized, statistics kernel",
                            base._replace(stats_kernel="fused"), mat,
                            {"cross": 1}))
        out = {}
        for name, cfg_e, sampler, expected in runs:
            engine = round_engine.RoundEngine(apply, opt, sampler, cfg_e)
            (p1, _, m), c = _window(
                f"equivalence round, {dtype}, {name}",
                lambda: engine.run(p0, opt.init(p0), 0, 1), expected)
            counts.append(c)
            out[name] = (p1, float(m.loss[0]))
        ref = out["materialized, per-client phase 1"][0]
        upd = utils.tree_max_abs_diff(ref, p0)
        rel = {name: utils.tree_max_abs_diff(p, ref) / upd
               for name, (p, _) in out.items()}
        dist[dtype] = rel[streamed]
        yard = rel.get("materialized, statistics kernel")
        print(f"streamed vs materialized, one round at full width in "
              f"{dtype} (K={K} x {N_PER_CLIENT}, server SGD lr {EQ_LR}): "
              f"max |p_streamed - p_materialized| / max |update| = "
              f"{rel[streamed]:.4e} (tol {STREAM_TOL[dtype]:g})"
              + ("" if yard is None else
                 f"; the statistics kernel against the per-client average:"
                 f" {yard:.4e}")
              + "; losses " + ", ".join(f"{n} {lo:.6f}"
                                        for n, (_, lo) in out.items()),
              flush=True)
        del out, ref, p0
    if not all(dist[dt] <= STREAM_TOL[dt] for dt in dist):
        fail("the streamed round departs from the materialized round")
    return counts


def fused_gradient_check(device):
    """The fused token step's gradient at micro FUSED_MICRO against micro
    1 on one batch of GRAD_B sequences of the full-width TinyLlama-1.1B
    tower, each in a window of its own. Returns the windows' counts."""
    cfg = get_config(TOK_ARCH)
    de_cfg = DualEncoderConfig(
        proj_dims=get_dual_encoder_config(TOK_ARCH).proj_dims, lambda_cco=5.0)
    params = dual_encoder.init_dual_encoder(0, cfg, de_cfg, device)
    gen = torch.Generator(device=device).manual_seed(7)
    views = [torch.randint(0, cfg.vocab_size, (GRAD_B, TOK_S), generator=gen,
                           device=device) for _ in range(2)]
    batch = {"view1": {"tokens": views[0]}, "view2": {"tokens": views[1]}}
    grads, counts = {}, []
    for micro in (1, FUSED_MICRO):
        step = steps_lib.make_dcco_train_step(
            cfg, de_cfg, TrainConfig(global_batch=GRAD_B, samples_per_client=TOK_N),
            opt_lib.sgd(1.0), num_microbatches=micro)
        (g, m), c = _window(
            f"fused step gradient, micro {micro}",
            lambda: step.grads(params, batch),
            {"flash": (FLASH_MICRO * micro if micro > 1
                       else 2 * TOK_LAYERS), "flash_bwd": FLASH_BWD * micro})
        counts.append(c)
        grads[micro] = (g, float(m["loss"]))
    g1, gm = grads[1][0], grads[FUSED_MICRO][0]
    sq_diff = sq_ref = dot = sq_m = 0.0
    for a, b in zip(utils.tree_leaves(g1), utils.tree_leaves(gm)):
        a, b = a.double(), b.double()
        sq_diff += float(((a - b) ** 2).sum())
        sq_ref += float((a * a).sum())
        sq_m += float((b * b).sum())
        dot += float((a * b).sum())
    rel = (sq_diff / sq_ref) ** 0.5
    cos = dot / (sq_ref * sq_m) ** 0.5
    print(f"fused step gradient, {TOK_ARCH} full width, {GRAD_B} sequences "
          f"of {TOK_S}: micro {FUSED_MICRO} vs micro 1: ||g_M - g_1|| / "
          f"||g_1|| = {rel:.4e} (tol {GRAD_TOL:g}), cosine {cos:.6f}; "
          f"losses {grads[1][1]:.6f} / {grads[FUSED_MICRO][1]:.6f}; "
          f"gradient types {utils.tree_leaves(g1)[0].dtype} / "
          f"{utils.tree_leaves(gm)[0].dtype}", flush=True)
    if not (rel <= GRAD_TOL and all(
            bool(torch.isfinite(x).all()) for x in utils.tree_leaves(gm))):
        fail("the microbatched step's gradient departs from the single "
             "step's")
    return counts


def streaming_and_modes(device, dcco_ref):
    """Phase 11 (see the module docstring). ``dcco_ref``: the materialized
    64-client D-CCO path's summary (peak GiB, ms/round), printed beside
    the streamed tree's. Returns the paths' and windows' counts."""
    counts = []
    rounds = PATH_ROUNDS
    stream = ["--clients-per-round", str(STREAM_K), "--cohort-chunk",
              str(STREAM_CHUNK)]
    c, res = train_path("streamed dcco", stream, TOK_STREAM_ROUNDS, {})
    counts.append(c)
    release(res)
    # the begin-round edge mass, then each chunk's statistics and deltas
    # through the int8 client hop (a column quantize each) and their fold
    # into the chunk's one edge (a segment sum each)
    chunks = STREAM_K // STREAM_CHUNK
    c, res = train_path(
        "streamed dcco over the int8 tree",
        [*stream, "--edges", "8", "--channel", "int8", "--edge-channel",
         "dense"], rounds, {"column": 2 * chunks * rounds,
                            "fold": (1 + 2 * chunks) * rounds})
    counts.append(c)
    steady = sorted(res["round_ms"][1:])
    ref_steady = sorted(dcco_ref["round_ms"][1:])
    ms, ref_ms = steady[len(steady) // 2], ref_steady[len(ref_steady) // 2]
    print(f"streamed tree (K={STREAM_K} in {chunks} chunks of "
          f"{STREAM_CHUNK}, int8 client hop) beside the materialized "
          f"K={K} D-CCO path: peak device memory {res['peak_gib']:.2f} vs "
          f"{dcco_ref['peak_gib']:.2f} GiB (ratio "
          f"{res['peak_gib'] / dcco_ref['peak_gib']:.3f}), median ms/round "
          f"{ms:.1f} vs {ref_ms:.1f} (ratio {ms / ref_ms:.2f})", flush=True)
    release(res)
    gc.collect()
    torch.cuda.empty_cache()
    counts += streamed_equivalence(device)
    # the ResNet's fused step and protocol loop: statistics in plain code
    # (no kernel), as the reference's
    for name, flags in (("fused", ["--mode", "fused"]),
                        ("protocol", ["--mode", "protocol"])):
        c, res = train_path(f"resnet {name} mode", flags, rounds, {})
        counts.append(c)
        release(res)
    gc.collect()
    torch.cuda.empty_cache()
    tok = ["--arch", TOK_ARCH, "--seq-len", str(TOK_S),
           "--samples-per-client", str(TOK_N)]
    peaks = {}
    for k in TOK_STREAM_KS:
        c, res = train_path(
            f"tinyllama dcco streamed K={k}",
            [*tok, "--clients-per-round", str(k), "--cohort-chunk",
             str(TOK_CHUNK)], TOK_STREAM_ROUNDS,
            {"flash": FLASH_CHUNK * (k // TOK_CHUNK) * TOK_STREAM_ROUNDS,
             "flash_bwd": FLASH_BWD * (k // TOK_CHUNK) * TOK_STREAM_ROUNDS})
        counts.append(c)
        peaks[k] = res["peak_gib"]
        release(res)
        gc.collect()
        torch.cuda.empty_cache()
    c, res = train_path(
        f"tinyllama fused micro {FUSED_MICRO}",
        [*tok, "--clients-per-round", str(FUSED_K), "--mode", "fused",
         "--micro", str(FUSED_MICRO)], TOK_STREAM_ROUNDS,
        {"flash": FLASH_MICRO * FUSED_MICRO * TOK_STREAM_ROUNDS,
         "flash_bwd": FLASH_BWD * FUSED_MICRO * TOK_STREAM_ROUNDS})
    counts.append(c)
    peaks["fused"] = res["peak_gib"]
    release(res)
    gc.collect()
    torch.cuda.empty_cache()
    counts += fused_gradient_check(device)
    print(f"tinyllama peak device memory: dcco streamed in chunks of "
          f"{TOK_CHUNK}: " + ", ".join(f"K={k} {peaks[k]:.2f} GiB"
                                       for k in TOK_STREAM_KS)
          + f" (materialized K={TOK_K} is printed above; K=8 materialized "
          f"exceeds the card); fused micro {FUSED_MICRO} over {FUSED_K} x "
          f"{TOK_N} sequences {peaks['fused']:.2f} GiB", flush=True)
    return counts


# phase 12: the DeepSeek family at full config (bf16 weights from seed 0).
# Serving: DS_B prompts of DS_PROMPT tokens, then DS_DECODE greedy decode
# steps. D-CCO: each tower cut to its dense prologue and one MoE layer
# (first_k_dense + 1 = 2 layers, widths kept): one f32 copy of a 16B tower
# is 65 GB, so a round's deltas and the server state cannot sit beside
# the full tower on 80 GB. DS_K clients x TOK_N sequences of TOK_S in
# chunks of DS_CHUNK, DS_ROUNDS rounds.
DS_ARCHS = ("deepseek-moe-16b", "deepseek-v2-lite-16b")
DS_B, DS_PROMPT, DS_DECODE = 4, 128, 8
DS_K, DS_CHUNK, DS_ROUNDS = 8, 4, 2


def dropped_share(routes, group, cap, experts):
    """The share of (token, rank) picks past their expert's capacity, from
    recorded routes (each (B, S, k)) with the tokens cut into groups of
    ``group`` as ``moe_forward`` cuts them: an expert keeps the first
    ``cap`` picks of its queue, so a group keeps sum_e min(picks_e, cap).
    It is the reference's ``dropped_frac``, averaged over the calls."""
    kept = total = 0
    for r in routes:
        picks = r.reshape(-1, group * r.shape[-1]).long()
        counts = (picks[..., None] == torch.arange(
            experts, device=picks.device)).sum(1)
        kept += int(counts.clamp(max=cap).sum())
        total += picks.numel()
    return 1.0 - kept / total


def _init_tower(cfg, device):
    """A full-config tower from seed 0, timed; freed by the caller."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tower = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    device)
    torch.cuda.synchronize()
    n = sum(x.numel() for x in utils.tree_leaves(tower))
    print(f"{cfg.name}: {n / 1e9:.3f}B parameters ({cfg.num_layers} layers, "
          f"{cfg.dtype}) drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return tower


def _no_drop(cfg):
    """``cfg`` with the capacity factor raised to E / k: every group's
    capacity is then at least its token count, so no grouping drops."""
    m = cfg.moe
    return cfg.replace(moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def decode_gate(label, cfg, tower, prompt):
    """Prefill and DS_DECODE greedy steps of ``cfg`` (a capacity with no
    drops), each step's logits against the last position of a full
    forward over the same tokens, one sequence at a time (B x S tokens
    must fill whole groups). In bf16, rounding flips top-k picks whose
    probabilities nearly tie between the two computations (other matrix
    shapes, the int8 cache's quantization), which moves a token's FFN by
    a whole expert. So each pair (sequence, step) is held twice: the free
    forward, where the pairs whose picks flip in some layer are printed
    with their layers and the others held to SRV_TOL x max(1, max
    |logits|); and the forward with the serving path's own picks imposed
    at every position and layer (``moe.force_routes``), every pair held
    to the same bound. Fails if a held pair departs."""
    n_moe = cfg.num_superblocks
    with moe_mod.record_routes() as served:
        out = serve_cli.generate(cfg, tower, prompt, DS_DECODE + 1)
    agree, flipped, worst, forced_worst, scale = 0, [], 0.0, 0.0, 1.0
    for j, logits in enumerate(out["logits"]):
        for i in range(prompt.shape[0]):
            seq = torch.cat([prompt[i], out["tokens"][i, :j]])[None]
            # the serving path's picks at each position: the prefill's,
            # then decode steps 1..j
            picks = [torch.cat([served[layer][i:i + 1]]
                               + [served[n_moe * t + layer][i:i + 1]
                                  for t in range(1, j + 1)], dim=1)
                     for layer in range(n_moe)]
            with moe_mod.record_routes() as full:
                want = _forward_logits(cfg, tower, seq)[0]
            with moe_mod.force_routes(picks):
                forced = _forward_logits(cfg, tower, seq)[0]
            scale = max(scale, float(want.abs().max()),
                        float(forced.abs().max()))
            forced_worst = max(forced_worst,
                               float((logits[i] - forced).abs().max()))
            layers = [
                layer for layer, (a, b) in enumerate(zip(picks, full))
                if not torch.equal(torch.sort(a[0, -1]).values,
                                   torch.sort(b[0, -1]).values)]
            if layers:
                flipped.append((i, j, layers))
                continue
            agree += 1
            worst = max(worst, float((logits[i] - want).abs().max()))
    pairs = prompt.shape[0] * (DS_DECODE + 1)
    print(f"{label}: decode gate at capacity factor "
          f"{cfg.moe.capacity_factor:.4g} (no drops), {pairs} (sequence, "
          f"step) pairs, tol {SRV_TOL * scale:.4e} (= {SRV_TOL} x "
          f"{scale:.3f}): the serving path's picks imposed, |logits - "
          f"full forward| worst {forced_worst:.4e} over all pairs; free "
          f"forward, {agree} pairs pick alike in every layer, worst "
          f"{worst:.4e}; flipped pairs (sequence, step: MoE layers) "
          f"{flipped or 'none'}", flush=True)
    if not (forced_worst <= SRV_TOL * scale and worst <= SRV_TOL * scale):
        fail(f"{label}: decode departs from a full forward")


def serve_deepseek(device, arch):
    """(b) or (c) of phase 12 on the full-config ``arch``: prefill and
    decode through ``serve.generate`` at the published capacity factor
    (the model-dtype cache and, for GQA, the int8 cache), each in a window
    of its own (flash once a layer in the prefill, none in decode), with
    prefill ms, decode ms a token, peak GiB and the dropped share of the
    prefill's and the decode steps' routing; then the decode gate; for
    MLA, one absorbed decode step against a naive one. Returns the
    windows' counts."""
    cfg = get_config(arch)
    tower = _init_tower(cfg, device)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (DS_B, DS_PROMPT),
                           generator=gen, dtype=torch.int32).to(device)
    serve_cli.generate(cfg, tower, prompt[:, :16], 2)     # cuBLAS warm-up
    m, n_moe = cfg.moe, cfg.num_superblocks
    caches = ("model",) if cfg.use_mla else ("model", "int8")
    windows = []
    for kv in caches:
        c = cfg.replace(kv_cache_dtype=kv)
        torch.cuda.reset_peak_memory_stats()
        with moe_mod.record_routes() as routes:
            out, counts = _window(
                f"serve {arch} ({kv} cache)",
                lambda: serve_cli.generate(c, tower, prompt, DS_DECODE + 1),
                {"flash": cfg.num_layers})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        windows.append(counts)
        group = min(512, DS_B * DS_PROMPT)
        pre = dropped_share(routes[:n_moe], group,
                            moe_mod._capacity(group, m), m.num_experts)
        dec = dropped_share(routes[n_moe:], DS_B,
                            moe_mod._capacity(DS_B, m), m.num_experts)
        cache_mib = sum(x.numel() * x.element_size() for x in
                        utils.tree_leaves(out["cache"])) / 2 ** 20
        finite = all(bool(torch.isfinite(x).all()) for x in out["logits"])
        print(f"serve {arch} ({kv} KV cache, {cache_mib:.1f} MiB): prefill "
              f"{DS_B}x{DS_PROMPT} {out['prefill_ms']:.3f} ms, decode "
              f"{out['decode_ms']:.3f} ms/token over {DS_DECODE} steps x "
              f"{DS_B}; peak device memory {peak:.2f} GiB; launches "
              f"{counts}; dropped_frac at capacity factor "
              f"{m.capacity_factor}: prefill {pre:.4f} (groups of {group}, "
              f"capacity {moe_mod._capacity(group, m)}), decode {dec:.4f} "
              f"(groups of {DS_B}, capacity {moe_mod._capacity(DS_B, m)}); "
              f"logits finite {finite}", flush=True)
        if not (finite and out["tokens"].shape == (DS_B, DS_DECODE + 1)):
            fail(f"serving {arch} with the {kv} cache")
        del out
        decode_gate(f"serve {arch} ({kv} cache)", _no_drop(c), tower, prompt)
    profile_decode(cfg, tower, prompt, "model", steps=4)
    if cfg.use_mla:
        check_mla_absorb(cfg, tower, prompt)
        int8 = transformer.init_cache(cfg.replace(kv_cache_dtype="int8"),
                                      DS_B, 8, device)
        kinds = sorted({str(x.dtype) for x in utils.tree_leaves(int8)})
        print(f"serve {arch}: the MLA cache ignores kv_cache_dtype (int8 "
              f"asked, leaves {kinds}), as the reference's does", flush=True)
        if "torch.int8" in kinds:
            fail("the MLA cache took kv_cache_dtype")
    del tower
    gc.collect()
    torch.cuda.empty_cache()
    return windows


def check_mla_absorb(cfg, tower, prompt):
    """One decode step of the first layer's MLA over its prefilled cache,
    absorbed (attention in the latent space) against naive (the cache
    expanded to per-head K/V), held to SRV_TOL x max(1, max |naive|) and
    each timed (CUDA events around 20 steps on a copy of the cache)."""
    c = transformer.init_cache(cfg, DS_B, DS_PROMPT + 1, prompt.device)
    transformer.prefill(cfg, tower, prompt, c)
    p = tower["prologue"][0]
    with torch.no_grad():
        x = rmsnorm(p["ln1"], embed(tower["embed"], prompt[:, -1:]),
                    cfg.norm_eps)
        outs, ms = {}, {}
        for absorb in (True, False):
            cache = {k: v.clone() for k, v in c["prologue"][0].items()}
            run = lambda: attn_mod.mla_decode(cfg, p["attn"], x, c["pos"],  # noqa: E731
                                              cache, absorb=absorb)[0]
            outs[absorb] = run()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                run()
            end.record()
            torch.cuda.synchronize()
            ms[absorb] = start.elapsed_time(end) / 20
    err = float((outs[True].float() - outs[False].float()).abs().max())
    scale = max(1.0, float(outs[False].float().abs().max()))
    print(f"mla decode, layer 0 at position {DS_PROMPT}, B={DS_B}: absorbed "
          f"vs naive |diff| {err:.4e} (tol {SRV_TOL * scale:.4e}); ms a "
          f"step (CUDA events around 20 steps, the host's issue "
          f"included): absorbed "
          f"{ms[True]:.4f}, naive {ms[False]:.4f}", flush=True)
    if not err <= SRV_TOL * scale:
        fail("the absorbed MLA decode departs from the naive one")


def deepseek_phase(device):
    """Phase 12 (see the module docstring). Returns (the (192, 128) flash
    instance's figures at MLA's prefill shape in bf16, the windows'
    counts, the flash launches of the MLA paths)."""
    torch.cuda.empty_cache()
    mla = get_config("deepseek-v2-lite-16b")
    dqk = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    mla_label = "MLA prefill (deepseek-v2-lite-16b)"
    figures = check_flash(DS_B, mla.num_heads, mla.num_heads, DS_PROMPT,
                          DS_PROMPT, dqk, torch.bfloat16, mla_label,
                          seed=40, dv=mla.v_head_dim, time_bwd=True)
    check_flash(2, 8, 8, 100, 100, dqk, torch.float32, "MLA dims, f32",
                seed=41, dv=mla.v_head_dim, time_bwd=True)
    counts, mla_flash = [], 0
    for arch in DS_ARCHS:
        c = serve_deepseek(device, arch)
        counts += c
        if arch == "deepseek-v2-lite-16b":
            mla_flash += sum(x["flash"] for x in c)
    peaks = {}
    for arch in DS_ARCHS:
        cfg = get_config(arch)
        layers = cfg.num_prologue + 1
        c, res = train_path(
            f"{arch} dcco, {layers} layers",
            ["--arch", arch, "--num-layers", str(layers), "--seq-len",
             str(TOK_S), "--samples-per-client", str(TOK_N),
             "--clients-per-round", str(DS_K), "--cohort-chunk",
             str(DS_CHUNK)], DS_ROUNDS,
            {"flash": 2 * 2 * layers * (DS_K // DS_CHUNK) * DS_ROUNDS,
             "flash_bwd": 2 * layers * (DS_K // DS_CHUNK) * DS_ROUNDS})
        counts.append(c)
        if cfg.use_mla:
            mla_flash += c["flash"]
        n = sum(x.numel() for x in utils.tree_leaves(res["params"]))
        peaks[arch] = (res["peak_gib"], n)
        release(res)
        gc.collect()
        torch.cuda.empty_cache()
    print("deepseek dcco at full width, cut depth: " + "; ".join(
        f"{a} {n / 1e9:.3f}B parameters, peak {g:.2f} GiB"
        for a, (g, n) in peaks.items()), flush=True)
    err, ms, plain_ms, lib_ms, (b_ms, b_by) = figures
    _, bwd_ms, bwd_plain_ms, bwd_lib_ms, (bb_ms, bb_by) = \
        FLASH_BWD_FIGURES[mla_label]
    fmt = (lambda x: "none" if x is None else f"{x:.5f} ms")
    print(f"flash (Dqk {dqk}, Dv {mla.v_head_dim}) at MLA's prefill shape: "
          f"kernel {ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}), sdpa "
          f"{fmt(lib_ms)}, plain {plain_ms:.5f} ms; its bf16 backward "
          f"{fmt(bwd_ms)}, bound {bb_ms:.5f} ms ({bb_by}), sdpa backward "
          f"{fmt(bwd_lib_ms)}, plain {fmt(bwd_plain_ms)}; launches on the "
          f"MLA paths {mla_flash}", flush=True)
    return figures, counts, mla_flash



# phase 13: the recurrent families at full config (bf16 weights from seed
# 0, drawn on the card). Serving: REC_B prompts of REC_PROMPT tokens, then
# REC_DECODE greedy decode steps. D-CCO: REC_K clients x TOK_N sequences
# of TOK_S, materialized, REC_ROUNDS rounds; zamba2-2.7b cut to one
# superblock (ZAMBA_CUT = 6 layers, widths kept): the whole 2.8B tower
# at K = 4 would hold K f32 deltas and the server's state beside it,
# where TinyLlama's 1.1B already peaks at ~58 GiB of the 80; xlstm-350m
# cut to 2 of its 12 superblocks (XLSTM_CUT = 4 layers), as the whole
# tower's round (~11 s, its first ~31 s, the sLSTM loop) held the
# script's time past half its limit.
REC_ARCHS = ("zamba2-2.7b", "xlstm-350m")
REC_B, REC_PROMPT, REC_DECODE = 4, 128, 16
REC_K, REC_ROUNDS, ZAMBA_CUT, XLSTM_CUT = 4, 2, 6, 4
REC_CUTS = {"zamba2-2.7b": ZAMBA_CUT, "xlstm-350m": XLSTM_CUT}


def _whole(cfg, s):
    """``cfg`` with each recurrent chunk set to ``s``: a full forward over
    ``s`` tokens as one chunk. The scans assert that the chunk divides the
    sequence (the reference's too), which a decode-gate length such as
    131 meets only at 1 or itself; any chunk is the same recurrence."""
    if cfg.ssm is not None:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=s))
    if cfg.xlstm is not None:
        cfg = cfg.replace(xlstm=dataclasses.replace(cfg.xlstm, chunk=s))
    return cfg


def layer_distances(cfg, tower, seq):
    """The last position's hidden state after each block: a prefill of
    ``seq[:, :-1]`` and one decode step against a full forward over
    ``seq``; for each block in order, (kind, max |difference|, the
    difference's RMS over the forward's)."""
    b, s = seq.shape
    full_cfg = _whole(cfg, s)
    with torch.no_grad():
        cache = transformer.init_cache(cfg, b, s, seq.device)
        transformer.prefill(_whole(cfg, s - 1), tower, seq[:, :-1], cache)
        xd = embed(tower["embed"], seq[:, -1:])
        xf = embed(tower["embed"], seq)
        positions = torch.arange(s, device=seq.device)[None].expand(b, s)
        dists = []
        for kind, p, c in transformer._blocks_and_caches(cfg, tower, cache):
            xd = transformer._block_decode(cfg, kind, p, xd, cache["pos"], c)
            xf, _ = transformer._block_forward(full_cfg, kind, p, xf,
                                               positions)
            d = xd[:, 0].float() - xf[:, -1].float()
            dists.append((kind, float(d.abs().max()), float(
                d.pow(2).mean().sqrt()
                / xf[:, -1].float().pow(2).mean().sqrt())))
    return dists


def _layer_line(dists):
    return ", ".join(f"{i}:{k} {d:.2e} ({r:.1e})"
                     for i, (k, d, r) in enumerate(dists))


def step_distances(cfg, tower, prompt, out):
    """Each step's logits (the prefill's first) against the last position
    of a full forward over the same tokens: (max |difference| a step, the
    scale max(1, max |forward logits|))."""
    errs, scale = [], 1.0
    for j, logits in enumerate(out["logits"]):
        seq = torch.cat([prompt, out["tokens"][:, :j]], dim=1)
        want = _forward_logits(_whole(cfg, seq.shape[1]), tower, seq)
        scale = max(scale, float(want.abs().max()))
        errs.append(float((logits - want).abs().max()))
    return errs, scale


def bf16_noise_floor(cfg, tower, seq):
    """Two bf16 full forwards over ``seq`` that differ only in the
    recurrent chunk (the whole sequence, and its largest proper divisor):
    the scans' f32 sums in another order, every bf16 rounding point and
    matrix product the same. Their max |difference| at the last
    position."""
    s = seq.shape[1]
    half = max(d for d in range(1, s) if s % d == 0)
    a = _forward_logits(_whole(cfg, s), tower, seq)
    b = _forward_logits(_whole(cfg, half), tower, seq)
    return float((a - b).abs().max())


def serve_recurrent(device, arch):
    """(b) or (c) of phase 13 on the full-config ``arch``: prefill and
    decode through ``serve.generate`` with each cache (the int8 one only
    where the tower has attention slots), each in a window of its own
    (flash once an attention layer in the prefill, none in decode), with
    the parameter count, prefill ms, decode ms a token and peak GiB. Then
    the decode gate. The bf16 steps' distance from a bf16 full forward is
    printed beside the bf16 noise floor (two forwards of the same tokens
    whose f32 scans are chunked differently) and the block-by-block
    distance: at random init, bf16 rounding of the matrix products'
    outputs, compounded over the depth and through the exponential gates,
    moves the logits by several percent (PERF.md §6), so it is not gated.
    The gate serves the same weights in f32
    compute (the bf16 values widened, f32 states as in bf16) and holds
    every step of each cache to a full f32 forward within SRV_TOL x
    max(1, max |logits|): the chunked scan against the step recurrence,
    with the rounding out of the way. Returns the windows' counts."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    tower = _init_tower(cfg, device)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (REC_B, REC_PROMPT),
                           generator=gen, dtype=torch.int32).to(device)
    serve_cli.generate(cfg, tower, prompt[:, :16], 2)     # cuBLAS warm-up
    n_attn = cfg.num_superblocks * cfg.block_pattern.count("attn")
    caches = ("model", "int8") if n_attn else ("model",)
    windows, outs = [], {}
    for kv in caches:
        c = cfg.replace(kv_cache_dtype=kv)
        torch.cuda.reset_peak_memory_stats()
        out, counts = _window(
            f"serve {arch} ({kv} cache)",
            lambda: serve_cli.generate(c, tower, prompt, REC_DECODE + 1),
            {"flash": n_attn})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        windows.append(counts)
        cache_mib = sum(x.numel() * x.element_size() for x in
                        utils.tree_leaves(out.pop("cache"))) / 2 ** 20
        finite = all(bool(torch.isfinite(x).all()) for x in out["logits"])
        print(f"serve {arch} ({kv} cache, {cache_mib:.1f} MiB): prefill "
              f"{REC_B}x{REC_PROMPT} {out['prefill_ms']:.3f} ms, decode "
              f"{out['decode_ms']:.3f} ms/token over {REC_DECODE} steps x "
              f"{REC_B}; peak device memory {peak:.2f} GiB; launches "
              f"{counts} (flash {n_attn} a prefill, 0 a decode step); "
              f"logits finite {finite}", flush=True)
        if not (finite and out["tokens"].shape == (REC_B, REC_DECODE + 1)):
            fail(f"serving {arch} with the {kv} cache")
        outs[kv] = out
    last = torch.cat([prompt, outs["model"]["tokens"][:, :-1]], dim=1)
    floor = bf16_noise_floor(cfg, tower, last)
    for kv in caches:
        errs, scale = step_distances(cfg.replace(kv_cache_dtype=kv), tower,
                                     prompt, outs[kv])
        print(f"serve {arch} ({kv} cache, bf16): |logits - bf16 full "
              f"forward| a step / scale {scale:.3f}: " + " ".join(
                  f"{e / scale:.4f}" for e in errs) + f"; bf16 noise floor "
              f"(two full forwards, the chunk {last.shape[1]} and "
              f"{last.shape[1] // 2}) {floor / scale:.4f}",
              flush=True)
    print(f"serve {arch} (model cache, bf16): block by block at step "
          f"{REC_DECODE}, max |decode - forward| (RMS over the forward's): "
          + _layer_line(layer_distances(cfg, tower, last)), flush=True)
    wide = utils.tree_map(lambda x: x.float() if x.is_floating_point()
                          else x, tower)
    del tower, outs
    torch.cuda.empty_cache()
    for kv in caches:
        c32 = cfg.replace(dtype="float32", kv_cache_dtype=kv)
        out = serve_cli.generate(c32, wide, prompt, REC_DECODE + 1)
        errs, scale = step_distances(c32, wide, prompt, out)
        print(f"serve {arch} ({kv} cache, f32 compute): decode gate over "
              f"{len(errs)} steps x {REC_B}, |logits - full forward| worst "
              f"{max(errs):.4e} (prefill {errs[0]:.4e}, last step "
              f"{errs[-1]:.4e}), tol {SRV_TOL * scale:.4e} (= {SRV_TOL} x "
              f"{scale:.3f})", flush=True)
        bad = [j for j, e in enumerate(errs) if e > SRV_TOL * scale]
        if bad:
            if bad[0] > 0:
                seq = torch.cat([prompt, out["tokens"][:, :bad[0]]], dim=1)
                print(f"serve {arch} ({kv} cache, f32 compute): step "
                      f"{bad[0]} departs; block by block: "
                      + _layer_line(layer_distances(c32, wide, seq)),
                      flush=True)
            fail(f"serve {arch} ({kv} cache): decode departs from a full "
                 f"forward")
        del out
    if not n_attn:
        int8 = transformer.init_cache(cfg.replace(kv_cache_dtype="int8"),
                                      REC_B, 8, device)
        kinds = sorted({str(x.dtype) for x in utils.tree_leaves(int8)})
        print(f"serve {arch}: the recurrent states ignore kv_cache_dtype "
              f"(int8 asked, leaves {kinds}), as the reference's do",
              flush=True)
        if "torch.int8" in kinds:
            fail("a recurrent state took kv_cache_dtype")
    del wide
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve {arch}: {time.perf_counter() - t0:.1f} s with its gates",
          flush=True)
    return windows


def recurrent_phase(device):
    """Phase 13 (see the module docstring). Returns (the (80, 80) flash
    instance's figures at zamba2's prefill shape in bf16, the windows'
    counts)."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    zamba = get_config("zamba2-2.7b")
    dh = zamba.resolved_head_dim
    figures = check_flash(REC_B, zamba.num_heads, zamba.num_kv_heads,
                          REC_PROMPT, REC_PROMPT, dh, torch.bfloat16,
                          "zamba2 prefill (Dh 80)", seed=50)
    check_flash(2, 8, 4, 100, 150, dh, torch.float32,
                "Dh 80, f32, ragged Sq 100 of Skv 150", seed=51,
                time_bwd=True)
    counts, dh80 = [], 0
    for arch in REC_ARCHS:
        c = serve_recurrent(device, arch)
        counts += c
        dh80 += sum(x["flash"] for x in c)
    peaks = {}
    for arch in REC_ARCHS:
        cfg = get_config(arch)
        flags = ["--arch", arch, "--seq-len", str(TOK_S),
                 "--samples-per-client", str(TOK_N), "--clients-per-round",
                 str(REC_K), "--stats-kernel", "fused"]
        cfg = cfg.replace(num_layers=REC_CUTS[arch])
        flags += ["--num-layers", str(REC_CUTS[arch])]
        n_attn = cfg.num_superblocks * cfg.block_pattern.count("attn")
        # phase 1 and phase 2 (K clients folded into one launch) each run
        # both views' forwards
        t0 = time.perf_counter()
        c, res = train_path(
            f"{arch} dcco, {cfg.num_layers} layers", flags, REC_ROUNDS,
            {"flash": 2 * 2 * n_attn * REC_ROUNDS,
             "flash_bwd": 2 * n_attn * REC_ROUNDS, "cross": REC_ROUNDS})
        counts.append(c)
        dh80 += c["flash"]
        n = sum(x.numel() for x in utils.tree_leaves(res["params"]))
        steady = sorted(res["round_ms"][1:])
        peaks[arch] = (res["peak_gib"], n, steady[len(steady) // 2],
                       {k: v / REC_ROUNDS for k, v in c.items() if v},
                       time.perf_counter() - t0)
        release(res)
        gc.collect()
        torch.cuda.empty_cache()
    print("recurrent dcco at full width: " + "; ".join(
        f"{a} {n / 1e9:.3f}B parameters, {ms:.1f} ms/round (median after "
        f"the first), peak {g:.2f} GiB, launches a round {per}, {sec:.1f} s "
        f"in all" for a, (g, n, ms, per, sec) in peaks.items()), flush=True)
    err, ms, plain_ms, lib_ms, (b_ms, b_by) = figures
    print(f"flash (80, 80) at zamba2's prefill shape: kernel {ms:.5f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}), sdpa "
          f"{'none' if lib_ms is None else f'{lib_ms:.5f} ms'}, plain "
          f"{plain_ms:.5f} ms; launches on the zamba2 paths {dh80}; phase "
          f"13 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return figures, counts


# phase 14: the last two archs at full config (bf16 weights from seed 0,
# drawn on the card). Serving: MM_B prompts of MM_PROMPT tokens (after
# internvl2-2b's 256 random patch embeddings), then MM_DECODE greedy
# decode steps. D-CCO: MM_K clients x TOK_N sequences of TOK_S,
# materialized, MM_ROUNDS rounds, each tower cut to MM_CUTS layers (widths
# kept): K = 4 f32 deltas of the whole 1.7B / 3.2B tower beside the
# server's state would not fit, where TinyLlama's 1.1B already peaks at
# ~58 GiB of the 80. The Fig. 1c step: FIG1C_N pairs of (TOK_S text
# tokens; one token and the patches).
MM_ARCHS = ("internvl2-2b", "musicgen-large")
MM_B, MM_PROMPT, MM_DECODE = 4, 128, 16
MM_K, MM_ROUNDS = 4, 2
MM_CUTS = {"internvl2-2b": 8, "musicgen-large": 12}
FIG1C_N = TOK_K * TOK_N


def _mm_logits(cfg, tower, tokens, patches):
    """Last-position logits of a full forward over the patches (if any)
    and ``tokens``."""
    with torch.no_grad():
        h = transformer.forward(cfg, tower, tokens, patches)
        return transformer.logits_from_hidden(cfg, tower, h[:, -1])


def mm_step_distances(cfg, tower, prompt, patches, out):
    """Each step's logits (the prefill's first) against the last position
    of a full forward over the same patches and tokens: (max |difference|
    a step, the scale max(1, max |forward logits|))."""
    errs, scale = [], 1.0
    for j, logits in enumerate(out["logits"]):
        seq = torch.cat([prompt, out["tokens"][:, :j]], dim=1)
        want = _mm_logits(cfg, tower, seq, patches)
        scale = max(scale, float(want.abs().max()))
        errs.append(float((logits - want).abs().max()))
    return errs, scale


def mm_noise_floor(cfg, tower, seq, patches):
    """Two bf16 full forwards over the same patches and tokens that differ
    only in how attention sums: on the flash kernel, and in plain torch
    over the materialized scores (``attn_impl="naive"``, as decode attends
    over its cache). Their max |difference| at the last position."""
    a = _mm_logits(cfg, tower, seq, patches)
    b = _mm_logits(cfg.replace(attn_impl="naive"), tower, seq, patches)
    return float((a - b).abs().max())


def serve_multimodal(device, arch):
    """(b) or (c) of phase 14 on the full-config ``arch``: prefill and
    decode through ``serve.generate`` with the model-dtype and the int8
    cache, each in a window of its own (flash once a layer in the prefill,
    none in decode), with the parameter count, prefill ms, decode ms a
    token and peak GiB. internvl2-2b serves as ``serve`` does, its cache
    sized prompt + gen + 1 as the reference sizes it: the patches overflow
    it, so decode attends to the last positions only; that run's distance
    from a full forward is printed, not gated (ROADMAP §3). The decode
    gate runs each cache over every position (P + prompt + gen + 1) and
    holds each step's logits to the last position of a full forward over
    the same patches and tokens, within SRV_TOL x max(1, max |logits|),
    beside the noise floor of the model's dtype. Returns the serving
    windows' counts."""
    t0 = time.perf_counter()
    cfg = get_config(arch)
    tower = _init_tower(cfg, device)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (MM_B, MM_PROMPT),
                           generator=gen, dtype=torch.int32).to(device)
    patches, n_pre = None, MM_PROMPT
    if cfg.modality == "vision_text":
        patches = torch.randn((MM_B, cfg.vis_patches, cfg.vis_dim),
                              generator=gen).to(device, torch.bfloat16)
        n_pre += cfg.vis_patches
    whole = n_pre + MM_DECODE + 2           # P + prompt + gen + 1
    serve_cli.generate(cfg, tower, prompt[:, :16], 2,        # warm-up
                       patch_embeds=patches)
    windows, gate = [], {}
    for kv in ("model", "int8"):
        c = cfg.replace(kv_cache_dtype=kv)
        torch.cuda.reset_peak_memory_stats()
        out, counts = _window(
            f"serve {arch} ({kv} cache)",
            lambda: serve_cli.generate(c, tower, prompt, MM_DECODE + 1,
                                       patch_embeds=patches),
            {"flash": cfg.num_layers})
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        windows.append(counts)
        slots = out["cache"]["layers"]["b0"]["kv_pos"].shape[-1]
        cache_mib = sum(x.numel() * x.element_size() for x in
                        utils.tree_leaves(out.pop("cache"))) / 2 ** 20
        finite = all(bool(torch.isfinite(x).all()) for x in out["logits"])
        print(f"serve {arch} ({kv} cache of {slots} positions, "
              f"{cache_mib:.1f} MiB): prefill {MM_B}x{n_pre} "
              f"({n_pre - MM_PROMPT} patches + {MM_PROMPT} tokens) "
              f"{out['prefill_ms']:.3f} ms, decode {out['decode_ms']:.3f} "
              f"ms/token over {MM_DECODE} steps x {MM_B}; peak device "
              f"memory {peak:.2f} GiB; launches {counts} (flash "
              f"{cfg.num_layers} a prefill, 0 a decode step); logits "
              f"finite {finite}", flush=True)
        if not (finite and out["tokens"].shape == (MM_B, MM_DECODE + 1)):
            fail(f"serving {arch} with the {kv} cache")
        if slots < whole:
            errs, scale = mm_step_distances(c, tower, prompt, patches, out)
            print(f"serve {arch} ({kv} cache): the reference's cache of "
                  f"prompt + gen + 1 = {slots} positions holds the last of "
                  f"the {whole - 1} a sequence reaches: |logits - full "
                  f"forward| / scale {scale:.3f} a step: " + " ".join(
                      f"{e / scale:.4f}" for e in errs) + " (not gated: "
                  f"the patches overflow it, as in the reference)",
                  flush=True)
            out = serve_cli.generate(c, tower, prompt, MM_DECODE + 1,
                                     patch_embeds=patches, max_len=whole)
        gate[kv] = mm_step_distances(c, tower, prompt, patches, out)
    last = torch.cat([prompt, out["tokens"][:, :-1]], dim=1)
    floor = mm_noise_floor(cfg, tower, last, patches)
    for kv, (errs, scale) in gate.items():
        print(f"serve {arch} ({kv} cache of {whole} positions, "
              f"{cfg.dtype}): decode gate over {len(errs)} steps x {MM_B}, "
              f"|logits - full forward| / scale {scale:.3f} a step: "
              + " ".join(f"{e / scale:.4f}" for e in errs) + f"; worst "
              f"{max(errs):.4e}, tol {SRV_TOL * scale:.4e} (= {SRV_TOL} x "
              f"{scale:.3f}); noise floor (two full forwards, attention on "
              f"the flash kernel and in plain torch) {floor / scale:.4f}",
              flush=True)
        if not max(errs) <= SRV_TOL * scale:
            fail(f"serve {arch} ({kv} cache): decode departs from a full "
                 f"forward")
    del tower
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve {arch}: {time.perf_counter() - t0:.1f} s with its gates",
          flush=True)
    return windows


def fig1c_step(device):
    """(e) of phase 14: one fused D-CCO step (``steps.make_dcco_train_step``)
    of internvl2-2b cut to MM_CUTS layers on the paper's cross-modal pair
    (Fig. 1c), the batch laid out by ``launch.inputs.train_input_specs``
    (view 1 text tokens, view 2 one token and the patch embeddings), in a
    window of its own (flash forward and backward once a layer and view),
    server Adam. Gates: a finite loss, and a
    nonzero, finite gradient of ``vis_proj`` (read from Adam's first
    moment, (1 - b1) g), which moved. Returns the window's counts."""
    cut = MM_CUTS["internvl2-2b"]
    cfg = get_config("internvl2-2b").replace(num_layers=cut)
    de = get_dual_encoder_config("internvl2-2b")
    params = dual_encoder.init_dual_encoder(0, cfg, de, device)
    specs = inputs_lib.train_input_specs(
        cfg, inputs_lib.InputShape("fig1c", TOK_S, FIG1C_N, "train"))
    gen = torch.Generator(device=device).manual_seed(2)

    def draw(spec):
        if spec.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, spec.shape,
                                 generator=gen, device=device,
                                 dtype=torch.int32)
        return torch.randn(spec.shape, generator=gen,
                           device=device).to(spec.dtype)

    batch = utils.tree_map(draw, specs)
    layout = {v: {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                  for k, x in batch[v].items()} for v in batch}
    opt = opt_lib.adam(1e-4)
    step = steps_lib.make_dcco_train_step(
        cfg, de, TrainConfig(global_batch=FIG1C_N,
                             samples_per_client=TOK_N), opt)
    state = opt.init(params)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (new, state, metrics), counts = _window(
        "fig1c step", lambda: step(params, state, batch),
        {"flash": 2 * cut, "flash_bwd": 2 * cut})
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    m = utils.tree_leaves(state["m"]["tower"]["vis_proj"])
    g_norm = float(torch.sqrt(sum(x.float().pow(2).sum() for x in m))) / 0.1
    moved = utils.tree_max_abs_diff(new["tower"]["vis_proj"],
                                    params["tower"]["vis_proj"])
    loss = float(metrics["loss"])
    finite = all(bool(torch.isfinite(x).all()) for x in m)
    print(f"fig1c step, internvl2-2b cut to {cut} layers, batch {layout}: "
          f"loss {loss:.6g}, |grad vis_proj| {g_norm:.4e} (finite "
          f"{finite}), vis_proj moved {moved:.4e}; {ms:.1f} ms (first "
          f"call); peak device memory {peak:.2f} GiB; launches {counts}",
          flush=True)
    if not (math.isfinite(loss) and finite and g_norm > 0 and moved > 0):
        fail("the Fig. 1c step: the loss or the patch projector's gradient")
    del params, new, state
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def multimodal_phase(device):
    """Phase 14 (see the module docstring). Returns (the figures of
    ``cco_stats`` at internvl2-2b's projection width, the windows'
    counts)."""
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    vlm, audio = get_config("internvl2-2b"), get_config("musicgen-large")
    dh = vlm.resolved_head_dim
    check_flash(MM_B, vlm.num_heads, vlm.num_kv_heads,
                vlm.vis_patches + MM_PROMPT, vlm.vis_patches + MM_PROMPT, dh,
                torch.bfloat16, "internvl2 prefill (256 patches + 128 "
                "tokens)", seed=60)
    check_flash(FIG1C_N, vlm.num_heads, vlm.num_kv_heads,
                vlm.vis_patches + 1, vlm.vis_patches + 1, dh, torch.bfloat16,
                "internvl2 Fig. 1c view 2 (1 token + 256 patches)", seed=61)
    check_flash(MM_B, audio.num_heads, audio.num_kv_heads, MM_PROMPT,
                MM_PROMPT, audio.resolved_head_dim, torch.bfloat16,
                "musicgen prefill (KVH = H)", seed=62)
    d = get_dual_encoder_config("internvl2-2b").proj_dims[-1]
    stats = check_cco_stats(MM_K * TOK_N, d, MM_K * TOK_N, 63) + (
        cco_stats_bound_ms(MM_K * TOK_N, d),)
    counts = []
    for arch in MM_ARCHS:
        counts += serve_multimodal(device, arch)
    peaks = {}
    for arch in MM_ARCHS:
        cut = MM_CUTS[arch]
        de = get_dual_encoder_config(arch)
        t0 = time.perf_counter()
        c, res = train_path(
            f"{arch} dcco, {cut} layers",
            ["--arch", arch, "--num-layers", str(cut), "--seq-len",
             str(TOK_S), "--samples-per-client", str(TOK_N),
             "--clients-per-round", str(MM_K), "--stats-kernel", "fused"],
            MM_ROUNDS, {"flash": 2 * 2 * cut * MM_ROUNDS,
                        "flash_bwd": 2 * cut * MM_ROUNDS,
                        "cross": MM_ROUNDS}, d_out=de.proj_dims[-1])
        counts.append(c)
        n = sum(x.numel() for x in utils.tree_leaves(res["params"]))
        steady = sorted(res["round_ms"][1:])
        note = ""
        if "vis_proj" in res["params"]["tower"]:
            # the text views give the patch projector no gradient: Adam
            # leaves it as initialised, as the reference's does
            init = dual_encoder.init_dual_encoder(
                0, get_config(arch).replace(num_layers=cut), de, device)
            same = all(torch.equal(a, b) for a, b in zip(
                utils.tree_leaves(res["params"]["tower"]["vis_proj"]),
                utils.tree_leaves(init["tower"]["vis_proj"])))
            del init
            note = f", vis_proj as initialised {same}"
            if not same:
                fail(f"{arch}: the text views moved the patch projector")
        peaks[arch] = (res["peak_gib"], n, steady[len(steady) // 2],
                       time.perf_counter() - t0, note)
        release(res)
        gc.collect()
        torch.cuda.empty_cache()
    print("multimodal dcco at full width, cut depth: " + "; ".join(
        f"{a} {MM_CUTS[a]} layers, {n / 1e9:.3f}B parameters, {ms:.1f} "
        f"ms/round (median after the first), peak {g:.2f} GiB, {sec:.1f} s "
        f"in all{note}" for a, (g, n, ms, sec, note) in peaks.items()),
        flush=True)
    counts.append(fig1c_step(device))
    print(f"phase 14 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return stats, counts


# phase 15: the cohort sharded over devices, on a world of one NCCL rank
# (NCCL takes one rank per device, so more ranks need more cards; the
# laws of worlds of 2 and 4 are held on CPU gloo ranks in
# tests/test_torch_sharded.py and tests/test_torch_multihost.py).
# SHARD_ROUNDS engine rounds of the full-width ResNet at K x N_PER_CLIENT,
# with the CLI's server optimizer (Adam on a cosine schedule from
# --server-lr); the shard_map step on TOK_K x TOK_N sequences of
# TinyLlama-1.1B; the corpus of RATE_N rows.
SHARD_ROUNDS = 3
# the shard_map step's gradient against the fused step's, both bf16 towers
# on the same batch: ||g_shard_map - g_fused|| / ||g_fused|| <= SHARD_GRAD_TOL
# and |loss difference| <= SHARD_GRAD_TOL x |loss|. On one rank the two
# compute the same arithmetic (the mean over one rank is the identity, the
# combine adds a zero, the gradient share is 1 / 1), so bf16 rounding of a
# kernel run twice is all that may differ.
SHARD_GRAD_TOL = 1e-2


def _free_port() -> int:
    """A free TCP port on the loopback interface, for the coordinator."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _collective_counts():
    return {k: dict(c) for k, c in collectives.counts.items()}


def sharded_rounds(device, mesh):
    """(a) of phase 15: SHARD_ROUNDS rounds of the full-width ResNet
    through ``RoundEngine(cohort_axis="data", mesh=...)`` against the
    unsharded engine's (``stats_kernel="off"``, the same per-client
    arithmetic), cuDNN's deterministic algorithms on. Gate: the sharded
    run's parameters within the distance between two unsharded runs (0
    when the round is deterministic), the statistics kernel never
    launched. Then the sharded engine over int8 through the 8-edge tree:
    finite losses, quant_dequant 2 and segment_sum 3 a round. Prints each
    round's all-reduces and all-gathers (calls, bytes) and ms a round
    sharded against unsharded. Returns the windows' counts."""
    cfg = get_config("resnet14-cifar")
    args = train.parse_args([
        "--full", "--clients-per-round", str(K), "--samples-per-client",
        str(N_PER_CLIENT), "--dataset-size", str(DATASET)])
    de_cfg = DualEncoderConfig(
        proj_dims=get_dual_encoder_config("resnet14-cifar").proj_dims,
        lambda_cco=args.lam)
    ds, _ = train.build_dataset(cfg, args)
    sampler = ds.make_round_sampler(K, device)
    apply = train.make_apply(cfg, de_cfg)
    p0 = dual_encoder.init_dual_encoder(0, cfg, de_cfg, device)

    def server_opt():
        return opt_lib.get_optimizer(args.server_optimizer,
                                     schedules.cosine_decay(args.server_lr,
                                                            SHARD_ROUNDS))

    base = round_engine.EngineConfig(lam=args.lam, chunk_rounds=1,
                                     stats_kernel="off")
    counts, out = [], {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, cfg_e, m in (
                ("unsharded", base, None),
                ("unsharded again", base, None),
                ("sharded", base._replace(cohort_axis="data",
                                          stats_kernel=None), mesh)):
            opt = server_opt()
            engine = round_engine.RoundEngine(apply, opt, sampler, cfg_e,
                                              mesh=m)
            laps = []

            def lap(*_):
                torch.cuda.synchronize()
                laps.append(time.perf_counter())

            collectives.reset_counts()
            lap()
            (p, _, metrics), c = _window(
                f"{name} engine, {SHARD_ROUNDS} rounds",
                lambda: engine.run(p0, opt.init(p0), 0, SHARD_ROUNDS,
                                   on_segment=lap), {})
            counts.append(c)
            ms = [(b - a) * 1e3 for a, b in zip(laps, laps[1:])]
            out[name] = (p, metrics.loss.tolist(), ms, _collective_counts())
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref = out["unsharded"][0]
    upd = utils.tree_max_abs_diff(ref, p0)
    floor = utils.tree_max_abs_diff(out["unsharded again"][0], ref)
    dist_ = utils.tree_max_abs_diff(out["sharded"][0], ref)
    coll = out["sharded"][3]
    per_round = {k: (c["calls"] / SHARD_ROUNDS, c["bytes"] / SHARD_ROUNDS)
                 for k, c in coll.items()}
    for name, (_, losses, ms, _) in out.items():
        print(f"phase 15 (a) {name}: K={K} x {N_PER_CLIENT} full-width "
              f"ResNet-14, {SHARD_ROUNDS} rounds, losses "
              f"{[float(f'{x:.6g}') for x in losses]}, ms a round "
              f"{[round(x, 2) for x in ms]} (first, then the rest)",
              flush=True)
    steady = {n: sum(o[2][1:]) / (len(o[2]) - 1) for n, o in out.items()}
    print(f"phase 15 (a) sharded (world of one NCCL rank, cohort_axis "
          f"'data') vs unsharded: max |p_sharded - p_unsharded| = "
          f"{dist_:.4e} (tol: the two unsharded runs' distance {floor:.4e}; "
          f"update {upd:.4e}); ms a round after the first: sharded "
          f"{steady['sharded']:.2f}, unsharded {steady['unsharded']:.2f} / "
          f"{steady['unsharded again']:.2f}; collectives a round: "
          + ", ".join(f"{k} {n:g} calls {b:.0f} bytes"
                      for k, (n, b) in per_round.items()), flush=True)
    if not dist_ <= floor:
        fail("the sharded engine departs from the unsharded engine")
    if per_round["all_reduce"][0] != 4 or per_round["all_gather"][0] != 0:
        fail(f"the lossless sharded round's collectives {per_round}, "
             f"expected 4 all-reduces and no all-gather a round")
    del out, ref
    # int8 through the 8-edge tree, sharded: each round quantizes the
    # statistics and the deltas (the column form) and folds the
    # begin-round edge mass, the statistics and the deltas into the edges
    opt = server_opt()
    channel = hierarchy.HierarchicalChannel(
        8, client_channel=comm.QuantizedChannel(8))
    engine = round_engine.RoundEngine(
        apply, opt, sampler, base._replace(cohort_axis="data",
                                           stats_kernel=None,
                                           channel=channel), mesh=mesh)
    collectives.reset_counts()
    t0 = time.perf_counter()
    (p, _, metrics), c = _window(
        f"sharded engine over int8 through 8 edges, {SHARD_ROUNDS} rounds",
        lambda: engine.run(p0, opt.init(p0), 0, SHARD_ROUNDS),
        {"column": 2 * SHARD_ROUNDS, "fold": 3 * SHARD_ROUNDS})
    sec = time.perf_counter() - t0
    counts.append(c)
    losses = metrics.loss.tolist()
    coll = _collective_counts()
    print(f"phase 15 (a) sharded over int8 through 8 edges: losses "
          f"{[float(f'{x:.6g}') for x in losses]}, uplink bytes a round "
          f"{metrics.wire_bytes.tolist()} (edge->server "
          f"{metrics.edge_bytes.tolist()}), {sec * 1e3 / SHARD_ROUNDS:.1f} "
          f"ms a round with the first; launches {c}; collectives a round: "
          + ", ".join(f"{k} {v['calls'] / SHARD_ROUNDS:g} calls "
                      f"{v['bytes'] / SHARD_ROUNDS:.0f} bytes"
                      for k, v in coll.items()), flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail("the sharded int8 tree's losses are not finite")
    del p, p0, engine
    return counts


def sharded_step(device, mesh):
    """(b) of phase 15: one fused D-CCO step's gradient of the full-width
    TinyLlama-1.1B dual encoder over TOK_K clients x TOK_N sequences of
    TOK_S tokens, ``dcco_impl="shard_map"`` on the mesh against
    ``"fused"`` without one, each in a window of its own (flash forward and
    backward 2 a layer).
    Returns the windows' counts."""
    cfg = get_config(TOK_ARCH)
    de_cfg = DualEncoderConfig(
        proj_dims=get_dual_encoder_config(TOK_ARCH).proj_dims, lambda_cco=5.0)
    params = dual_encoder.init_dual_encoder(0, cfg, de_cfg, device)
    gen = torch.Generator(device=device).manual_seed(8)
    n = TOK_K * TOK_N
    batch = {f"view{i + 1}": {"tokens": torch.randint(
        0, cfg.vocab_size, (n, TOK_S), generator=gen, device=device)}
        for i in range(2)}
    grads, counts = {}, []
    for impl, m in (("fused", None), ("shard_map", mesh)):
        step = steps_lib.make_dcco_train_step(
            cfg, de_cfg, TrainConfig(global_batch=n, samples_per_client=TOK_N,
                                     dcco_impl=impl), opt_lib.sgd(1.0),
            mesh=m)
        collectives.reset_counts()
        t0 = time.perf_counter()
        (g, metrics), c = _window(f"{impl} step gradient",
                                  lambda: step.grads(params, batch),
                                  {"flash": 2 * TOK_LAYERS,
                                   "flash_bwd": 2 * TOK_LAYERS})
        ms = (time.perf_counter() - t0) * 1e3
        counts.append(c)
        grads[impl] = (g, float(metrics["loss"]), ms, _collective_counts())
    (gf, lf, msf, _), (gs, ls, mss, coll) = grads["fused"], grads["shard_map"]
    sq_d = sq_f = 0.0
    for a, b in zip(utils.tree_leaves(gf), utils.tree_leaves(gs)):
        a, b = a.double(), b.double()
        sq_d += float(((a - b) ** 2).sum())
        sq_f += float((a * a).sum())
    rel = (sq_d / sq_f) ** 0.5
    print(f"phase 15 (b) {TOK_ARCH} full width, {n} sequences of {TOK_S}, "
          f"bf16: shard_map step (world of one) vs fused: ||g_sm - g_f|| / "
          f"||g_f|| = {rel:.4e}, losses {ls:.6f} / {lf:.6f} (tol "
          f"{SHARD_GRAD_TOL:g}); ms (first call) {mss:.1f} / {msf:.1f}; "
          f"flash launches {counts[1]['flash']} / {counts[0]['flash']}; "
          f"collectives: "
          + ", ".join(f"{k} {v['calls']} calls {v['bytes']} bytes"
                      for k, v in coll.items()), flush=True)
    if not (rel <= SHARD_GRAD_TOL
            and abs(ls - lf) <= SHARD_GRAD_TOL * abs(lf)
            and all(bool(torch.isfinite(x).all())
                    for x in utils.tree_leaves(gs))):
        fail("the shard_map step departs from the fused step")
    del params, grads, gf, gs
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def sharded_corpus(device):
    """(c) of phase 15: ``ShardedCorpusIndex`` over a corpus mesh of one
    rank, RATE_N unit rows of d MAIN_D in f32, SERVE_BATCH queries, k
    MIPS_K: its search (the offset form, one launch) equal bit for bit to
    ``CorpusIndex.search`` (the search form). Returns the windows'
    counts."""
    mesh = make_corpus_mesh()
    gen = torch.Generator(device=device).manual_seed(51)
    emb = unit_rows(RATE_N, MAIN_D, gen)
    q = unit_rows(SERVE_BATCH, MAIN_D, gen)
    index = retrieval.CorpusIndex(emb)
    sharded = retrieval.ShardedCorpusIndex(emb, 1, mesh=mesh)
    collectives.reset_counts()
    got, c1 = _window("sharded corpus search",
                      lambda: sharded.search(q, MIPS_K), {"offset": 1})
    coll = _collective_counts()
    want, c2 = _window("unsharded corpus search",
                       lambda: index.search(q, MIPS_K), {"search": 1})
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    print(f"phase 15 (c) ShardedCorpusIndex over a corpus mesh of one, "
          f"{RATE_N} rows x {MAIN_D}, {SERVE_BATCH} queries, k {MIPS_K}: "
          f"equal to CorpusIndex.search bit for bit {same}; launches "
          f"{c1} / {c2}; collectives: "
          + ", ".join(f"{k} {v['calls']} calls {v['bytes']} bytes"
                      for k, v in coll.items()), flush=True)
    if not same:
        fail("the sharded corpus search differs from the unsharded search")
    del emb, index, sharded
    torch.cuda.empty_cache()
    return [c1, c2]


def sharded_phase(device):
    """Phase 15 (see the module docstring): a world of one NCCL rank set
    up through the REPRO_* contract on a loopback coordinator. Any failure
    to join it is a failure: nothing runs unsharded or on gloo instead.
    Returns the windows' counts."""
    t_phase = time.perf_counter()
    env = {"REPRO_COORDINATOR": f"127.0.0.1:{_free_port()}",
           "REPRO_NUM_PROCESSES": "1", "REPRO_PROCESS_ID": "0"}
    if not maybe_initialize_distributed(env):
        fail("the REPRO_* environment did not initialize a process group")
    try:
        if torch.distributed.get_backend() != "nccl":
            fail(f"phase 15 joined a {torch.distributed.get_backend()} "
                 f"world, not NCCL")
        mesh = make_debug_mesh(1)
        print(f"phase 15: world of {torch.distributed.get_world_size()} "
              f"NCCL rank, mesh {mesh}", flush=True)
        counts = sharded_rounds(device, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        counts += sharded_step(device, mesh)
        counts += sharded_corpus(device)
        print(f"phase 15 {time.perf_counter() - t_phase:.1f} s", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        production_layouts(device)
    finally:
        torch.distributed.destroy_process_group()
    return counts


# phase 16: the nine examples of repro_torch.examples and the reference's
# sharding layouts. (a) each example through its ``main`` (EXAMPLES: name,
# argv, the launches its path makes), in a launch window of its own,
# cuDNN's deterministic algorithms on (the examples' Eq.-3 exactness
# lines print max|diff| between two runs); federated_vicreg also with
# ``--channel none``, where no quantized wire keeps the statistics
# kernel's full moment set from running. quickstart, dual_encoder_text
# and serve_retrieval run at the reference scripts' defaults; the six
# with a "CI smoke" line in their docstrings at those arguments (SMOKE),
# since at their defaults phase 16 took 101.5 s on the card, past its
# 90 s (federated_cifar, 28.4 s of it at its defaults, joined them to
# make room for phase 17). Rounds of
# the smoke ResNet: the engine's D-CCO body takes ``cco_stats`` once a
# round (cross; the full set for D-VICReg and D-WMSE) unless the channel
# needs per-client payloads; an int8 client hop quantizes the statistics
# and the deltas (column 2 a round); a lossy two-level tree folds the edge
# mass, the statistics and the deltas (segment_sum 3 a round); the
# buffered engine folds the dispatch and its count (2 a tick); the
# FedAvg+CCO, contrastive and centralized bodies, the DP and dropout
# channels, streamed cohorts and the Appendix-A check (fed_sim's rounds,
# no statistics function) launch nothing. The smoke token towers (2
# layers, f32, Dh 32) take flash 2 a forward: dual_encoder_text's fused
# step over 2 microbatches makes 12 a microbatch (phase 1, the
# checkpointed forward and its recompute, 2 views) and 4 backwards a
# microbatch, its two probes 2 forwards each; serve_retrieval's index build 2 a chunk of 64, the queries 2, the
# drift probes 2 and 2 a refreshed block, the prefill 2, decode none.
QS_ROUNDS, TEXT_ROUNDS, SMOKE_ROUNDS = 30, 40, 3
SMOKE = ["--rounds", str(SMOKE_ROUNDS), "--dataset-size", "120"]
TEXT_FLASH = 2 * 12 * TEXT_ROUNDS + 2 * 2
TEXT_FLASH_BWD = 2 * 4 * TEXT_ROUNDS
EXAMPLES = [
    ("quickstart", [], {"cross": QS_ROUNDS}),
    # dcco on each of the 3 splits
    ("federated_cifar", SMOKE, {"cross": 3 * SMOKE_ROUNDS}),
    ("federated_vicreg", SMOKE, {"column": 3 * 2 * SMOKE_ROUNDS}),
    ("federated_vicreg", SMOKE + ["--channel", "none"],
     {"cross": SMOKE_ROUNDS, "full": 2 * SMOKE_ROUNDS}),
    # dense: the flat statistics; int8: both payloads quantized
    ("federated_comm", SMOKE, {"cross": SMOKE_ROUNDS,
                               "column": 2 * SMOKE_ROUNDS}),
    ("federated_noniid", SMOKE, {"cross": 4 * SMOKE_ROUNDS}),
    # flat dense, then two int8 trees; the 3-round flat run and the
    # dense-dense tree of the check, which collapses to the flat sum but
    # still folds its per-edge mass when a round begins (1 a round); one
    # streamed cohort of 32 (60 clients hold one chunk-aligned cohort)
    ("federated_hierarchy", SMOKE + ["--mega-cohort", "64"],
     {"cross": SMOKE_ROUNDS + 2 * 3, "column": 2 * 2 * SMOKE_ROUNDS,
      "fold": 2 * 3 * SMOKE_ROUNDS + 3}),
    # the sync run; two buffered runs; the check's sync run and the
    # buffered run at K = cohort (which runs the sync body)
    ("federated_async", SMOKE, {"cross": SMOKE_ROUNDS + 2 * 3,
                                "fold": 2 * 2 * SMOKE_ROUNDS}),
    ("dual_encoder_text", [], {"flash": TEXT_FLASH,
                               "flash_bwd": TEXT_FLASH_BWD}),
    # 256 docs in chunks of 64; warm-up and one batch of queries; 4 shards;
    # k-means of 8 iterations (sums and counts)
    ("serve_retrieval", [], lambda out: {
        "flash": 2 * (256 // 64) + 2 + 2 * (
            1 + int(out["refresh"]["blocks_refreshed"])) + 2,
        "search": 2, "offset": 4, "fold": 16}),
]


def _numbers(tree, key=""):
    """(key, float) of every number in an example's summary."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _numbers(v, str(k))]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _numbers(v, key)]
    if isinstance(tree, (int, float)) and not isinstance(tree, bool):
        return [(key, float(tree))]
    return []


def quickstart_f64(device):
    """The quickstart's Appendix-A check (step 3) on its own inputs, in
    f64: the f32 ratio it prints is rounding at the smoke config's
    GroupNorm of 2-channel groups (ROADMAP section 3), so the identity is
    gated here where it holds, at 1e-4 of the update
    (tests/test_torch_examples.py)."""
    from repro_torch.examples import _common, quickstart

    args = types.SimpleNamespace(device=device.type, dataset_size=600,
                                 classes=5)
    s = _common.resnet_setup(args)
    ds = _common.label_sharded({"images": s.imgs}, s.labels,
                               num_clients=128, samples_per_client=2)
    batch, sizes = ds.round_batch(utils.generator(42, device),
                                  quickstart.COHORT, device)

    def f64(tree):
        return utils.tree_map(lambda x: x.double(), tree)
    ratio = quickstart.appendix_a_ratio(s.apply, f64(s.params0), f64(batch),
                                        sizes)
    print(f"quickstart's Appendix-A check in f64 on the card: |fed - "
          f"centralized| / |update| = {ratio:.3e}", flush=True)
    if not ratio < 1e-4:
        fail("the quickstart's D-CCO round does not equal its centralized "
             "step in f64")


def examples_phase(device):
    """(a) of phase 16; returns the windows' counts."""
    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    counts = []
    try:
        for name, argv, expected in EXAMPLES:
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            buf = io.StringIO()

            def run():
                with contextlib.redirect_stdout(buf):
                    return mod.main(argv)
            t0 = time.perf_counter()
            out, c = _window(f"example {name} {argv}", run, expected)
            wall = time.perf_counter() - t0
            counts.append(c)
            lines = buf.getvalue().rstrip().splitlines()
            for line in lines[-8:]:
                print(f"  {name}| {line}", flush=True)
            print(f"example {' '.join([name, *argv])}: {wall:.2f} s wall, "
                  f"kernel launches "
                  f"{ {k: v for k, v in c.items() if v} }", flush=True)
            nums = _numbers({k: v for k, v in out.items()
                             if k not in ("params", "generated")})
            bad = [(k, v) for k, v in nums if not math.isfinite(v)
                   and k != "epsilon"]
            bad += [(k, v) for k, v in nums
                    if k.startswith("probe") and not 0.0 <= v <= 1.0]
            for key in ("tree_vs_flat", "buffered_vs_sync"):
                if key in out and out[key] != 0.0:
                    bad.append((key, out[key]))
            if not nums or bad:
                fail(f"example {name}: {bad or 'no numbers'}")
            if name == "quickstart":
                quickstart_f64(device)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    print(f"phase 16 (a) {time.perf_counter() - t_phase:.1f} s", flush=True)
    return counts


LAYOUT_ARCH = "tinyllama-1.1b"
STAND_INS = {"(16, 16)": ((16, 16), ("data", "model")),
             "(2, 16, 16)": ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass
class _StandIn:
    """A production mesh's axis names and sizes, for the layout rules."""
    shape: tuple
    mesh_dim_names: tuple


def production_layouts(device):
    """(b)-(d) of phase 16, in phase 15's world of one: the production
    mesh; the full-width TinyLlama-1.1B parameters (random bf16 of the
    shapes-only tree, drawn on the card from seed 0) laid out with
    ``distribute_tensor`` by ``named(mesh, param_pspecs(...))``, with
    the mesh's own specs and with the (16, 16) stand-in's of both modes,
    ``full_tensor()`` bit for bit; each token arch's parameter bytes a
    device under both modes on both stand-ins, from its shapes-only
    tree."""
    from torch.distributed.tensor import distribute_tensor

    t0 = time.perf_counter()
    mesh = make_production_mesh()
    if tuple(mesh.shape) != (1, 1) or \
            tuple(mesh.mesh_dim_names) != ("data", "model"):
        fail(f"make_production_mesh() on a world of one gave {mesh}")
    try:
        make_production_mesh(multi_pod=True)
    except ValueError as e:
        print(f"phase 16 (b): make_production_mesh() = {mesh}; "
              f"multi_pod=True refused: {e}", flush=True)
    else:
        fail("make_production_mesh(multi_pod=True) took a world of one")

    gen = torch.Generator(device=device).manual_seed(0)
    params = utils.tree_map(
        lambda x: torch.randn(x.shape, generator=gen, device=device).to(
            x.dtype), inputs_lib.param_shapes(get_config(LAYOUT_ARCH)))
    n_params = sum(x.numel() for x in utils.tree_leaves(params))
    stand_in = _StandIn(*STAND_INS["(16, 16)"])
    for label, spec_tree in (
            ("the mesh's own tp specs", specs.param_pspecs(params, mesh)),
            ("(16, 16) tp specs", specs.param_pspecs(params, stand_in)),
            ("(16, 16) fsdp specs",
             specs.param_pspecs(params, stand_in, mode="fsdp"))):
        placed = {}

        def lay_out(path, leaf, spec):
            placements = specs.named(mesh, spec)
            dt = distribute_tensor(leaf, mesh, placements)
            if not torch.equal(dt.full_tensor(), leaf):
                fail(f"phase 16 (c): {LAYOUT_ARCH} {path} under {spec} "
                     f"did not come back bit for bit")
            key = str(placements)
            placed[key] = placed.get(key, 0) + 1
        specs._map_with_path(lay_out, params, spec_tree)
        torch.cuda.synchronize()
        print(f"phase 16 (c): {LAYOUT_ARCH} ({n_params} parameters) laid "
              f"out by {label} on {tuple(mesh.shape)}, every leaf back bit "
              f"for bit; leaves by placements {placed}", flush=True)
    del params
    torch.cuda.empty_cache()

    gib = 2 ** 30
    for arch in ARCH_IDS:
        if arch == "resnet14-cifar":
            continue
        cfg = get_config(arch)
        tree = inputs_lib.param_shapes(cfg)
        total = sum(x.numel() * x.element_size()
                    for x in utils.tree_leaves(tree))
        m = _StandIn(*STAND_INS["(16, 16)"])
        cells = [f"{mode} {specs.device_bytes(tree, specs.param_pspecs(tree, m, mode=mode), m) / gib:.4f} GiB"  # noqa: E501
                 for mode in ("tp", "fsdp")]
        # the dual encoder's Adam state under ZeRO-1, on both stand-ins
        adam = inputs_lib.opt_state_shapes(
            opt_lib.adam(1e-3), inputs_lib.dual_encoder_shapes(
                cfg, get_dual_encoder_config(arch)))
        for name, (shape, names) in STAND_INS.items():
            m = _StandIn(shape, names)
            zero1 = specs.opt_state_pspecs(specs.param_pspecs(adam, m), adam,
                                           m)
            cells.append(f"Adam state ZeRO-1 on {name} "
                         f"{specs.device_bytes(adam, zero1, m) / gib:.4f} GiB")
        print(f"phase 16 (d): {arch} parameters {total / gib:.4f} GiB in "
              f"all; a device of (16, 16): " + ", ".join(cells), flush=True)
    print(f"phase 16 (b)-(d) {time.perf_counter() - t0:.1f} s", flush=True)


# phase 17: the dry run. (a) a subset of `launch.dryrun`'s cases that
# covers every family (dense GQA on all four shapes and a multi-pod train,
# MoE train, MLA decode, the Mamba2 hybrid's and the xLSTM's prefill, the
# vision-text train) and the reference's other D-CCO losses (shard_map,
# per_client), each cut to one superblock so that the traces fit the
# phase's time; the sweep at full depth is the CLI's (`--all --multi-pod
# both`, PERF.md). (b) the trace held to a real run on a world of one,
# for the fused and the shard_map step: the same step, the same FLOPs,
# the peak within DRY_BAND (the band PERF.md stated before the first
# run).
DRY_CASES = [("tinyllama-1.1b", s, False) for s in (
    "train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
    ("tinyllama-1.1b", "train_4k", True),
    ("deepseek-moe-16b", "train_4k", False),
    ("deepseek-v2-lite-16b", "decode_32k", False),
    ("zamba2-2.7b", "prefill_32k", False),
    ("xlstm-350m", "prefill_32k", False),
    ("internvl2-2b", "train_4k", False)] + [
    ("tinyllama-1.1b", "train_4k", False, impl)
    for impl in ("shard_map", "per_client")]
DRY_MICRO = 2
DRY_WORKERS = 6
DRY_ARCH, DRY_B, DRY_S = "tinyllama-1.1b", 8, 128
DRY_BAND = 0.20


def _dry_case(arch, shape, multi_pod, impl="fused"):
    """One case of phase 17 (a), in a worker process: the record. A train
    case with another loss than the fused one runs at micro 1, where the
    loss is the impl's (the microbatched step takes every impl's gradient
    as the combine's)."""
    from repro_torch.launch import dryrun
    cfg = get_config(arch)
    cfg = cfg.replace(num_layers=cfg.num_prologue + len(cfg.block_pattern))
    return dryrun.run_case(arch, shape, multi_pod, device="cuda", cfg=cfg,
                           num_microbatches=DRY_MICRO if impl == "fused"
                           else 1, dcco_impl=impl)


def _dry_line(rec):
    r, m, c = rec["roofline"], rec["memory"], rec["collectives"]
    axes = {k: f"{v['wire_bytes'] / 2 ** 20:.1f}MiB/{v['calls']}"
            for k, v in c["by_axis"].items()}
    impl = f" {rec['dcco_impl']}" if "dcco_impl" in rec else ""
    return (f"{rec['arch']} {rec['shape']}{impl} "
            f"{'multi' if rec['multi_pod'] else 'single'} {rec['mesh']}: "
            f"trace {rec['trace_s']} s, peak {m['peak_bytes'] / 2 ** 30:.3f} "
            f"GiB a device (arguments {m['argument_size_in_bytes']}, temp "
            f"{m['temp_size_in_bytes']}), {rec['flops_per_device']:.4e} "
            f"FLOP (flash {rec['flash_calls']} forward and "
            f"{rec['flash_backward_calls']} backward calls), "
            f"{rec['bytes_per_device']:.4e} B, wire by axis {axes}; "
            f"compute {r['compute_s']:.4e} s, memory {r['memory_s']:.4e} "
            f"s, collectives {r['collective_s']:.4e} s: {r['dominant']}")


def dryrun_phase(device):
    """Phase 17 (see the module docstring); returns (b)'s windows'
    counts."""
    import multiprocessing

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(DRY_WORKERS) as pool:
        recs = pool.starmap(_dry_case, DRY_CASES)
    for rec in recs:
        vals = [rec["flops_per_device"], rec["bytes_per_device"],
                rec["memory"]["peak_bytes"], rec["roofline"]["compute_s"]]
        if not all(math.isfinite(v) and v > 0 for v in vals):
            fail(f"phase 17 (a): {rec['arch']} {rec['shape']}: {vals}")
        print("phase 17 (a) " + _dry_line(rec), flush=True)
    print(f"phase 17 (a) {time.perf_counter() - t_phase:.1f} s "
          f"({len(recs)} cases, {DRY_WORKERS} workers)", flush=True)

    # (b) each step's fake trace on a world of one, then the step for
    # real: the fused step alone, the shard_map step on a world of one
    # NCCL rank (phase 15's, joined anew) with the explicit mesh
    shape = inputs_lib.InputShape("phase17", DRY_S, DRY_B, "train")
    cfg = get_config(DRY_ARCH).replace(attn_impl="blockwise", remat="full")
    de_cfg = get_dual_encoder_config(DRY_ARCH)
    opt = opt_lib.adam(5e-3)
    windows = []
    for impl in ("fused", "shard_map"):
        t0 = time.perf_counter()
        with dryrun.fake_world(1):
            mesh = make_production_mesh(ranks_per_host=1, device_type="cuda")
            with FakeTensorMode(allow_non_fake_inputs=True):
                step, args = dryrun.build_case(DRY_ARCH, shape, mesh,
                                               num_microbatches=1,
                                               dcco_impl=impl)
                fake_rec = dryrun.trace_step(step, args, mesh)
        del step, args
        trace_s = time.perf_counter() - t0
        tcfg = TrainConfig(global_batch=DRY_B, dcco_impl=impl)
        if impl == "fused":
            real_step = steps_lib.make_dcco_train_step(
                cfg, de_cfg, tcfg, opt, num_microbatches=1,
                constrain_sharding=True)
            real = _dry_real(device, cfg, de_cfg, opt, real_step, fake_rec,
                             "phase 17 (b) real step")
            coll = ""
        else:
            env = {"REPRO_COORDINATOR": f"127.0.0.1:{_free_port()}",
                   "REPRO_NUM_PROCESSES": "1", "REPRO_PROCESS_ID": "0"}
            if not maybe_initialize_distributed(env):
                fail("phase 17 (b): the REPRO_* environment did not "
                     "initialize a process group")
            try:
                if torch.distributed.get_backend() != "nccl":
                    fail(f"phase 17 (b) joined a "
                         f"{torch.distributed.get_backend()} world, not "
                         f"NCCL")
                real_step = steps_lib.make_dcco_train_step(
                    cfg, de_cfg, tcfg, opt, mesh=make_debug_mesh(1),
                    num_microbatches=1)
                collectives.reset_counts()
                real = _dry_real(device, cfg, de_cfg, opt, real_step,
                                 fake_rec, "phase 17 (b) real shard_map "
                                           "step")
                coll = "; the real step's collectives: " + ", ".join(
                    f"{k} {v['calls']} calls {v['bytes']} bytes"
                    for k, v in _collective_counts().items())
            finally:
                torch.distributed.destroy_process_group()
        loss, real_flops, peak, n_flash, counts = real
        windows.append(counts)
        fake_peak = fake_rec["memory"]["peak_bytes"]
        print(f"phase 17 (b): {DRY_ARCH} {impl} step {DRY_B} x {DRY_S} on "
              f"a world of one: trace {trace_s:.1f} s, loss {loss:.4f}; "
              f"FLOPs trace {fake_rec['flops_per_device']:.6e} real "
              f"{real_flops:.6e}; peak trace {fake_peak / 2 ** 30:.4f} GiB "
              f"real max_memory_allocated {peak / 2 ** 30:.4f} GiB (ratio "
              f"{peak / fake_peak:.4f}, band {DRY_BAND}); flash {n_flash} "
              f"calls; the trace's collectives "
              f"{fake_rec['collectives']['count_by_op']}{coll}", flush=True)
        if not math.isfinite(loss):
            fail(f"phase 17 (b) {impl}: loss {loss}")
        if real_flops != fake_rec["flops_per_device"]:
            fail(f"phase 17 (b) {impl}: FLOPs differ: trace "
                 f"{fake_rec['flops_per_device']}, real {real_flops}")
        if abs(peak / fake_peak - 1.0) > DRY_BAND:
            fail(f"phase 17 (b) {impl}: peak {peak} outside {DRY_BAND} of "
                 f"the trace's {fake_peak}")
    check_flash(DRY_B, 32, 4, DRY_S, DRY_S, 64, torch.bfloat16,
                "phase 17 (b) step shape")
    print(f"phase 17 {time.perf_counter() - t_phase:.1f} s", flush=True)
    return windows


def _dry_real(device, cfg, de_cfg, opt, real_step, fake_rec, label):
    """(b)'s step run for real: random weights of the shapes-only tree,
    drawn on the card, then one step in a launch window (flash as many
    times as the trace recorded) under ``FlopCounterMode``, the peak
    counted from the step's arguments in place. Returns the loss, the
    FLOPs (with the flash formula), the peak bytes, the flash calls and
    the window's counts."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import flash_attention as flash_mod

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    gen = torch.Generator(device=device).manual_seed(0)
    params = utils.tree_map(
        lambda x: (torch.randn(x.shape, generator=gen, device=device)
                   * 0.02).to(x.dtype),
        inputs_lib.dual_encoder_shapes(cfg, de_cfg))
    state = opt.init(params)
    batch = {v: {"tokens": torch.randint(
        0, cfg.vocab_size, (DRY_B, DRY_S), generator=gen, device=device,
        dtype=torch.int32)} for v in ("view1", "view2")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def run():
        with flash_mod.record_calls() as calls, \
                FlopCounterMode(display=False) as fc:
            out = real_step(params, state, batch)
        torch.cuda.synchronize()
        return out, calls, fc.get_total_flops()

    (out, calls, flops), counts = _window(
        label, run, {"flash": fake_rec["flash_calls"],
                     "flash_bwd": fake_rec["flash_backward_calls"]})
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(out[2]["loss"])
    real_flops = flops + sum(flash_mod.call_flops(c) for c in calls)
    del out, params, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return loss, real_flops, peak, len(calls), counts


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print("nvidia-smi name, power.limit:", flush=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    device = utils.resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    _build.build(list(_build.KERNELS))
    print(f"build: {time.perf_counter() - t0:.2f} s wall "
          f"(nvcc seconds {_build.build_seconds})", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # kernel vs plain version at the main paths' shapes, then ragged ones
    n_params = sum(x.numel() for x in utils.tree_leaves(
        dual_encoder.init_dual_encoder(
            0, get_config("resnet14-cifar"),
            get_dual_encoder_config("resnet14-cifar"), device)))
    n_stats = MAIN_D * MAIN_D + 4 * MAIN_D      # the DCCO stats payload
    figures = {
        "cross": check_cco_stats(MAIN_N, MAIN_D, MAIN_N, 0) + (
            cco_stats_bound_ms(MAIN_N, MAIN_D),),
        "full": check_cco_stats(MAIN_N, MAIN_D, MAIN_N, 0, "full") + (
            cco_stats_bound_ms(MAIN_N, MAIN_D, "full"),),
    }
    # the token path's N = 8, a ragged shape, a large N
    for n, d, valid in ((8, 1024, 8), (37, 1000, 30), (4096, 1024, 4096)):
        for moments in ("cross", "full"):
            check_cco_stats(n, d, valid, 1, moments)
    figures["per_row"] = check_quant(K, 1 << 20, False, 2) + (
        None, quant_bound_ms(K, 1 << 20, False))
    check_quant(K, n_stats, True, 3)
    figures["column"] = check_quant(K, n_params, True, 4, calls=5,
                                    replays=4) + (
        None, quant_bound_ms(K, n_params, True))
    for two_d in (False, True):
        check_quant(5, 4099, two_d, 5)
    torch.cuda.empty_cache()
    # segment_sum at every (K, D, E) of its paths: D = the stats payload,
    # the parameters, both plus three scalars (the buffered dispatch), or
    # one (a mass or count); E = 8 edges or ring slots, 4 clusters
    n_dispatch = n_stats + n_params + 3
    seg_figures = {}
    for i, (d, e, label) in enumerate((
            (n_params, 8, "hierarchy deltas"),
            (n_stats, 8, "hierarchy stats"),
            (n_params, 4, "cluster deltas"),
            (n_stats, 4, "cluster stats + k-means"),
            (n_dispatch, 8, "buffered dispatch"),
            (1, 8, "mass / count"))):
        ids = torch.randint(0, e, (K,), generator=torch.Generator(
            device=device).manual_seed(10 + i), device=device)
        seg_figures[label] = check_segment_sum(K, d, e, ids, 20 + i, label)
    ragged = torch.randint(0, 8, (37,), generator=torch.Generator(
        device=device).manual_seed(30), device=device)
    ragged = torch.where(ragged >= 7, 7, ragged)   # padding id E = 7
    ragged[ragged == 3] = 7                         # segment 3 empty
    check_segment_sum(37, 4099, 7, ragged, 31, "ragged, padding ids, "
                      "empty segments")
    check_segment_sum(K, n_stats, K, torch.arange(K), 32,
                      "one segment per client")
    check_fold_to_edges(device, K, 8)
    # phase 11's streamed tree: each chunk folds its clients into its one
    # edge (both payloads), and begin_round's edge mass (unweighted)
    # spans the whole cohort
    one_edge = torch.zeros(STREAM_CHUNK, dtype=torch.int32, device=device)
    check_segment_sum(STREAM_CHUNK, n_params, 1, one_edge, 33,
                      "streamed chunk deltas")
    check_segment_sum(STREAM_CHUNK, n_stats, 1, one_edge, 34,
                      "streamed chunk stats")
    check_segment_sum(STREAM_K, 1, 8, contiguous_edge_ids(STREAM_K, 8), 35,
                      "streamed edge mass", weighted=False)
    check_fold_to_edges(device, STREAM_CHUNK, 1)
    lap("phases 1-2 (build, kernels)")

    appendix_a(device, "dcco")
    appendix_a(device, "dvicreg")
    runs = [
        train_path("dcco", ["--stats-kernel", "fused"], ROUNDS,
                   {"cross": ROUNDS}),
        train_path("dvicreg",
                   ["--objective", "dvicreg", "--stats-kernel", "fused"],
                   PATH_ROUNDS, {"full": PATH_ROUNDS}),
        # no --stats-kernel: a lossy channel takes the per-client phase 1
        train_path("dcco over int8", ["--channel", "int8",
                                      "--quant-kernel", "fused"],
                   PATH_ROUNDS, {"column": 2 * PATH_ROUNDS}),
        # begin_round's per-edge mass, the stats fold, the deltas fold;
        # the int8 client hop quantizes both payloads
        train_path("hierarchical", ["--edges", "8", "--channel", "int8",
                                    "--edge-channel", "dense"],
                   PATH_ROUNDS, {"fold": 3 * PATH_ROUNDS,
                                 "column": 2 * PATH_ROUNDS}),
        # k-means: sums and counts in each of 2 Lloyd iterations; the
        # stats and the deltas: a fold and a mass each
        train_path("clustered", ["--clusters", "4"], PATH_ROUNDS,
                   {"fold": 8 * PATH_ROUNDS}),
        # the dispatch fold and the count fold of each tick
        train_path("buffered", ["--async-k", "32", "--latency-tail", "1.0",
                                "--staleness", "poly"], PATH_ROUNDS,
                   {"fold": 2 * PATH_ROUNDS}),
        # the retrieval eval after every round: one search of 512 queries
        # over a 1536-item corpus
        train_path("retrieval", ["--retrieval-eval", "--retrieval-every",
                                 "1", "--retrieval-corpus", "1536",
                                 "--retrieval-queries", "512"], PATH_ROUNDS,
                   {"cross": PATH_ROUNDS, "search": PATH_ROUNDS})]
    dcco_ref = {"peak_gib": runs[0][1]["peak_gib"],
                "round_ms": runs[0][1]["round_ms"]}
    lap("phases 3, 4 and 6 (Appendix A, the ResNet paths)")
    fedavg = fedavg_paths()
    drifted = drift_paths(device)
    lap("phases 8-9, ResNet (FedAvg, drift)")
    mips_figures = check_mips_laws(device)
    served = serving_phase(device, runs[-1][1]["params"])
    served += serving_rate(device)
    lap("phases 5 and 10, retrieval serving")
    runs = [counts for counts, _ in runs] + fedavg + drifted + served
    # the token path, with the serving phase's corpora released
    gc.collect()
    torch.cuda.empty_cache()
    figures["flash"] = check_flash_shapes()
    check_flash_gradient()
    lap("phase 7, flash shapes")
    tok_flags = ["--arch", TOK_ARCH, "--seq-len", str(TOK_S),
                 "--clients-per-round", str(TOK_K),
                 "--samples-per-client", str(TOK_N)]
    # phase 2's vmapped clients: one backward a layer and view
    counts, tok_dcco = train_path(
        "tinyllama dcco", [*tok_flags, "--stats-kernel", "fused"],
        TOK_ROUNDS, {"flash": 2 * 2 * TOK_LAYERS * TOK_ROUNDS,
                     "flash_bwd": 2 * TOK_LAYERS * TOK_ROUNDS,
                     "cross": TOK_ROUNDS})
    runs.append(counts)
    release(tok_dcco)
    gc.collect()
    torch.cuda.empty_cache()
    # no phase 1: the two views' forwards of phase 2 alone, the K clients
    # folded into one launch a layer and view by the Function's vmap rule
    counts, tok_fedavg = train_path(
        "tinyllama fedavg_contrastive", tok_flags, TOK_ROUNDS,
        {"flash": 2 * TOK_LAYERS * TOK_ROUNDS,
         "flash_bwd": 2 * TOK_LAYERS * TOK_ROUNDS}, "fedavg_contrastive")
    runs.append(counts)
    release(tok_fedavg)
    gc.collect()
    torch.cuda.empty_cache()
    # FedProx's two local steps: phase 1's 44 forwards, then 44 forwards
    # and 44 backwards in each step of phase 2
    prox = ["--fedprox-mu", MU, "--local-steps", "2", "--client-lr",
            TOK_PROX_LR, "--stats-kernel", "fused"]
    tok_expected = {"flash": 3 * 2 * TOK_LAYERS * TOK_ROUNDS,
                    "flash_bwd": 2 * 2 * TOK_LAYERS * TOK_ROUNDS,
                    "cross": TOK_ROUNDS}
    try:
        counts, tok_prox = train_path("tinyllama dcco fedprox",
                                      [*tok_flags, *prox], TOK_ROUNDS,
                                      tok_expected)
    except torch.cuda.OutOfMemoryError:
        print(f"tinyllama dcco fedprox: out of memory at K={TOK_K}, last "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
              f"running K=2", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        counts, tok_prox = train_path(
            "tinyllama dcco fedprox (K=2)",
            [*tok_flags, *prox, "--clients-per-round", "2"], TOK_ROUNDS,
            tok_expected)
    runs.append(counts)
    release(tok_prox)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phases 7-9, TinyLlama paths")
    runs += serving_phase_tokens(device)
    gc.collect()
    torch.cuda.empty_cache()
    runs += checkpoint_resume(device)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 10, token serving and checkpoints")
    runs += streaming_and_modes(device, dcco_ref)
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 11")
    _, ds_counts, _ = deepseek_phase(device)
    runs += ds_counts
    gc.collect()
    torch.cuda.empty_cache()
    lap("phase 12")
    _, rec_counts = recurrent_phase(device)
    runs += rec_counts
    gc.collect()
    torch.cuda.empty_cache()
    _, mm_counts = multimodal_phase(device)
    runs += mm_counts
    gc.collect()
    torch.cuda.empty_cache()
    runs += sharded_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    runs += examples_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    runs += dryrun_phase(device)
    lap("phases 13-17")
    print(f"tinyllama peak device memory: fedavg_contrastive "
          f"{tok_fedavg['peak_gib']:.2f} GiB, dcco "
          f"{tok_dcco['peak_gib']:.2f} GiB, dcco fedprox (2 local steps) "
          f"{tok_prox['peak_gib']:.2f} GiB", flush=True)
    # launches of each kernel on the main paths, read from their counts
    # (the per-row form runs on none of them, nor in the reference)
    figures["fold"] = seg_figures["hierarchy deltas"]
    figures["search"] = mips_figures["training eval"]
    figures["offset"] = mips_figures["shard"]
    figures["flash_bwd"] = FLASH_BWD_FIGURES[TOK_PATH]
    launches = {name: sum(c[name] for c in runs) for name in figures}

    rows = []
    for name, source, replaces in (
            ("cross", "cco_stats.cu", "kernels/cco_stats.py:37"),
            ("full", "cco_stats.cu", "kernels/cco_stats.py:74"),
            ("per_row", "quantize.cu", "kernels/quantize.py:29"),
            ("column", "quantize.cu", "kernels/quantize.py:36"),
            ("fold", "segment_sum.cu", "kernels/segment_sum.py:35"),
            ("search", "mips_topk.cu", "kernels/mips_topk.py:66"),
            ("offset", "mips_topk.cu", "kernels/mips_topk.py:97"),
            ("flash", "flash_attention.cu", "kernels/flash_attention.py:29"),
            # no Pallas counterpart: the gradient of the reference's
            # checkpointed online-softmax scan
            ("flash_bwd", "flash_attention_bwd.cu",
             "models/attention.py:56")):
        err, ms, plain_ms, lib_ms, (b_ms, b_by) = figures[name]
        kernel = {"cco_stats.cu": "cco_stats_" + name,
                  "quantize.cu": "quant_dequant_" + name,
                  "segment_sum.cu": "segment_sum",
                  "mips_topk.cu": {"search": "mips_topk",
                                   "offset": "mips_topk_offset"}.get(name),
                  "flash_attention.cu": "flash_attention",
                  "flash_attention_bwd.cu": "flash_attention_bwd"}[source]
        rows.append({
            "name": kernel, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/{replaces}",
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
