#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of HAM (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all started together);
3. hold each kernel against its plain PyTorch version on the card at the
   serving shapes of internlm2-20b, olmoe-1b-7b, xlstm-1.3b and zamba2-2.7b
   (and qwen2-moe's expert width), float32 and bfloat16 (decode attention
   also at each cluster size it splits the cache into, with splits left
   empty), and time kernel, plain version and, where one exists, the
   one-call PyTorch yardstick (``scaled_dot_product_attention``,
   ``torch.bmm``; none computes mLSTM or SSD); each grouped-matmul, mLSTM
   and SSD line names the route it took, and the mLSTM and SSD kernels are
   also timed by pass and beside the CUDA-core route they replaced; the
   two variants the attention kernels gained with the zoo's remaining
   paths are held and timed too: flash with a causal sliding window at
   zamba2's shape (S 1024 / W 256, S 8192 / W 4096, each beside the causal
   call, which the window must undercut by 10% at S 8192) and decode over
   an int8 cache with float32 scales (internlm2-20b's shape, ragged and
   whole, beside the bf16 kernel and SDPA on the dequantized cache, at each
   cluster size, with its launch's registers, shared memory and blocks an
   SM), with
   whisper-large-v3's encoder and cross-attention flash (Sq 448, Skv 1500)
   and its cross-attention decode (1500 frames); both attention kernels at
   nemotron-4-340b's head_dim 192, float32 and bfloat16, timed too; the
   decode kernel's row log-sum-exp (``lse=``) against the plain one, and
   the kernel timed with it and without in turns;
4. model checks: internlm2-20b, olmoe-1b-7b and qwen2-moe-a2.7b at full
   width cut to 2 layers, xlstm-1.3b cut to one group of 8 layers and
   zamba2-2.7b cut to 2 groups (12 Mamba2 blocks, 2 shared-block
   applications), nemotron-4-340b (head_dim 192) cut to 1 layer, float32
   weights (xlstm-1.3b and zamba2-2.7b also in
   bfloat16, the tensor-core routes of their mLSTM and SSD kernels),
   prefill + 4 decode steps with the kernels on the card against the plain
   path on the CPU (MoE routing near-ties between the two are reported, not
   hidden; the recurrent states are compared too; the first mLSTM and
   Mamba2 layers' states are also held against the plain mLSTM and SSD on
   the card, on the same activations); xlstm-1.3b (48 layers) and
   zamba2-2.7b (54 Mamba2 blocks) at their published depth, float32, a
   2 x 16-token prefill and 8 greedy steps on the card, on the CPU and on
   the CPU in float64 (each side decoding the float64 run's greedy tokens):
   logits within 1e-2 of float64 and 3x the float32 CPU's distance, greedy
   tokens equal wherever float64's top-2 margin exceeds 1e-2 (near-ties
   reported), in a child process that runs beside phases 8 and 9 and is
   read after them; then zamba2-2.7b (2 groups) with a
   256-token window over a 1024-token prompt and 8 decode steps across the
   ring's wrap, whisper-large-v3 at 2 + 2 layers (prefill over 1500 stub
   frames, both caches, 8 decode steps), internvl2-76b at 2 layers (256
   patches + 8 tokens, 4 decode steps) and internlm2-20b with the int8 cache
   (2 layers, 12 steps from position 0), float32, card against CPU;
5. serve internlm2-20b, olmoe-1b-7b, qwen2-moe-a2.7b, xlstm-1.3b and
   zamba2-2.7b, each at its full published config in bfloat16 (seeded random
   weights): 16 greedy requests (prompts of 64–1024 tokens, 64–256 for
   xlstm-1.3b) through ``run()``, a profiled window of decode steps, two
   ``step_many(16)`` blocks replaying the greedy step captured as a CUDA graph
   (the first captures it after one eager step) against 16 eager ``step()``
   calls from the same state (token-identical, exact decode launches, the
   capture's time and pool bytes, a profiled graphed block), a profiled window
   of 1024-token admissions (one for xlstm-1.3b, whose sLSTM prefill is a
   host loop of ~150 k small launches), and one sampled request, with the
   kernels' launch counters zeroed before and checked after each model;
   5b. the remaining attention paths at full config in bf16, each with its
   counters zeroed before and checked after: zamba2-2.7b with the
   long-context window 4096 served (8 slots, 8 requests of 3900–4000
   tokens, 256 new tokens each, so every request wraps the ring;
   graphed ``step_many(16)`` against 16 ``step()`` calls with every lane
   crossing the wrap), internlm2-20b (48 layers) decoded 64 steps over the int8
   cache beside the bf16 cache (logits within 0.05 of its max), and
   whisper-large-v3 (32 + 32 layers, 8 x 1500 frames, 64 greedy steps) and
   internvl2-76b (full width, 2 of 80 layers; 256 patches, 32 greedy
   steps) decoded;
6. cluster serving through the port's HAM runtime: internlm2-20b at full
   config in bfloat16 through ``ClusterServingEngine`` (2 thread workers x 4
   slots, ``max_len`` 2048), worker-driven (decode blocks of 16), lockstep
   and worker-driven on one 4-slot worker, on 8 requests of 32 new
   tokens, each token-identical to one 4-slot ``ServingEngine`` on the same
   requests; exact decode and flash launch counts, tokens/s, TTFT and host
   RPCs per emitted token (below 0.1 worker-driven), each worker-driven
   replica's decode blocks replaying its captured greedy step;
7. process fabrics (host code; the reference's non-smoke sizes): 7a runs
   right after phase 1, before this process holds a CUDA context, on forked
   workers (and fresh interpreters): the paper's Fig. 3 analogue (median
   round trip of ``demo/empty`` and ``demo/empty_static`` over 2000 calls on
   the local fabric, shm with a forked and with a fresh-interpreter worker,
   and socket with a fresh-interpreter worker), chain-replicated puts on
   ``ClusterPool.shm(4, replicas=0/1/2)`` with every holder's bytes checked,
   a killed primary recovered from its replica, and ``pool.mutate`` of
   ``demo/saxpy`` against get-mutate-put, bit for bit as numpy; 7b runs
   after phase 6 with CUDA up: an shm and a socket fresh-interpreter worker
   pass the digest ping, add two 8 MiB float32 CUDA tensors bit for bit as
   ``(a + b).cpu()`` and hold a CUDA tensor put into a buffer, and the shm
   worker answers again after a kill and a respawn; every worker not killed
   on purpose leaves on the shutdown message with exit code 0;
8. training on the card: 8a holds the flash-attention backward kernel,
   given the row log-sum-exp the forward writes (itself held against the
   plain one), against autograd through the plain attention
   (internlm2-20b's, zamba2's d 80, whisper's encoder and cross, a window,
   a ragged length and d 192, float32 on the CUDA cores and bfloat16 on
   the tensor cores; repeated calls bit for bit), times the forward with
   and without its LSE output at phase 3's shapes, holds the
   grouped-matmul backward (olmoe's prefill, a ragged capacity and both
   training shapes) against its plain version, bf16 reading x, w and dy in
   place (the call allocates dx and dw and nothing more) and timed in
   turns with the transposed-copies path it replaced (that path's copies
   and products timed one by one), and the mLSTM and SSD backward kernels
   against autograd through their plain chunked forms (xlstm-1.3b's and
   zamba2-2.7b's training shapes and S 509, float32 and bfloat16, each
   limit below what a backward skipping one chunk reads; repeated calls
   bit for bit), times them beside bound, plain and the PyTorch yardstick
   where one exists (each bf16 call in turns with its CUDA-core route, the
   SSD's scratch bytes on both routes, and each backward's device time by
   kernel), and checks that the decode ops raise under grad; 8b
   holds one step's float32 gradients card against CPU (B 1 x S 128) of
   internlm2-20b and olmoe-1b-7b (2 layers), xlstm-1.3b (8 layers: one
   group of 7 mLSTM + 1 sLSTM) and zamba2-2.7b (6 Mamba2 blocks, one
   shared-attention application), then trains internlm2-20b and 8c
   olmoe-1b-7b (2 layers, 12 steps), xlstm-1.3b (8 layers, 2 steps: its
   sLSTM loop makes ~25 launches a position) and zamba2-2.7b (6 layers,
   12 steps) at full width (float32 params, bf16 compute, full remat, B 4
   x S 2048, lr 1e-4) through ``Trainer.register_handlers`` and
   ``train/run_steps`` on a local ``OffloadDomain``: every step-1 gradient
   leaf finite and non-zero, the loss falling, exact launches of every
   kernel (``train_launches``), step times, tokens/s, model-FLOPs share,
   peak memory and a profiled step; 8d restarts a narrow
   internlm2-shaped trainer from its checkpoint on the card and holds the
   next 3 losses to the uninterrupted run's within 1e-6;
9. sharding and launch, through a 1 x 1 ("data", "model") DTensor mesh
   over a one-rank NCCL group: 9a trains phase 8's internlm2-20b cell
   through ``Trainer(sharder=)`` (every param and moment a DTensor; the
   losses phase 8's within 1e-5 relative, flash launches exact, step time
   and peak memory beside phase 8's); 9b decodes internlm2-20b at all 48
   layers in bf16 (a 1024-token prefill, 16 steps) and 9c olmoe-1b-7b with
   its experts on the model axis (EP), each sharded beside unsharded on
   the same params: logits within 1e-3, greedy tokens identical, exact
   launches a step; 9d the H100 roofline of 9a's and 9b's steps, counted
   by ``launch/op_analysis.py`` on ``meta`` in a fresh interpreter, each
   measured time at least 0.95x its bound; 9e (host only, fresh
   interpreters beside 9a-9d) ``python -m repro_torch.launch.dryrun`` of
   internlm2-20b train_4k and decode_32k and llama3-405b train_4k on
   pod16x16 (256 fake ranks), per-GPU bytes against 80 GB;
10. the port's static analysis and its examples: ``python -m
   repro_torch.analysis.hamlint`` over ``src/repro_torch`` (exit 0) and
   over ``tests/fixtures/hamlint_bad_torch`` (exit 1), ``modelcheck
   --quick`` (5 passes), then the four example twins (``examples/torch_*``)
   on the card, each in a fresh interpreter: the serve twin on
   olmoe-1b-7b at full config in bf16, the train twin through its
   restart, the quickstart and the offload pipeline; each exits 0 with its
   own last line, and the serve and train runs' kernel launches are exact
   for the steps and admissions they print;
11. print the kernel line, one serving line per model, the phase 5b line,
   the cluster serving line, the process-fabrics line, the train line, the
   sharded line and the examples line (JSON);
12. last line: ``{"ok": true, "device": {...}}``.

Needs CUDA; imports nothing of JAX or of the reference package ``repro``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import runpy
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): the bound of a kernel
# is the larger of bytes / memory rate and operations / peak for the type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # as tests/test_kernels.py
# grouped matmul: |kernel - plain| <= atol + rtol * |plain|.  float32 keeps
# 2e-5; a bfloat16 output is one rounding of an O(1) float32 sum, and one
# bf16 step above |4| is already 3.1e-2, hence the relative term
GMM_TOL = {"float32": (2e-5, 0.0), "bfloat16": (2e-2, 1e-2)}
LOGIT_ATOL = 1e-3  # float32 logits, card vs CPU: sums over d=6144/16384 in another order
# a token whose k-th and (k+1)-th router probabilities are closer than the
# card/CPU rounding may take another expert on each side; such a token must
# have a margin below this, and the positions it reaches are left out of
# the logit comparison
NEAR_TIE = 1e-5
DEVICE = "cuda"  # where every phase runs; a CPU rehearsal of the phases may set "cpu"

# (E, C, d, f, view, what): view "pad" reads x and w as strided views of
# tensors whose rows are padded to a multiple of 8 elements, with ragged
# rows (d, f no multiples of 8: TMA reads zeros past the edge; an odd f
# stores single elements); "layer" reads w as one layer's up half of stacked
# (layers, E, d, 2f) expert weights
GMM_CASES = [
    (64, 8, 2048, 1024, "", "olmoe decode gate/up"),
    (64, 8, 1024, 2048, "", "olmoe decode down"),
    (64, 160, 2048, 1024, "", "olmoe 1024-token prefill gate/up"),
    (64, 37, 2048, 1024, "", "olmoe prefill, C = 37"),
    (64, 200, 2048, 1024, "", "olmoe prefill, C = 200"),
    (64, 160, 2048, 1024, "layer", "olmoe prefill on a layer slice of stacked weights"),
    (64, 8, 2048, 1024, "layer", "olmoe decode on a layer slice of stacked weights"),
    (60, 8, 2048, 1408, "", "qwen2-moe decode gate/up"),
    (60, 160, 2048, 1408, "", "qwen2-moe prefill gate/up, f = 1408"),
    (3, 5, 40, 24, "", "small ragged"),
    (3, 5, 38, 22, "pad", "ragged strided views, decode"),
    (3, 37, 38, 22, "pad", "ragged strided views, prefill"),
    (3, 5, 38, 21, "pad", "ragged strided views, odd f, decode"),
    (3, 37, 38, 21, "pad", "ragged strided views, odd f, prefill"),
]
# timed shapes (E, C, d, f): olmoe's decode gate (the main path's regime: 48
# calls per step) and down projection, and prefills of 64, 160 and 256 slots
# (TTFT mixes them) at the gate and, at 160, the down projection
GMM_TIMED = {"decode": (64, 8, 2048, 1024), "decode_down": (64, 8, 1024, 2048),
             "prefill": (64, 160, 2048, 1024), "prefill_c64": (64, 64, 2048, 1024),
             "prefill_c256": (64, 256, 2048, 1024), "prefill_down": (64, 160, 1024, 2048)}
# arch -> (B, T, per-slot decode positions); MoE prompts keep B*T <= 256
# tokens, one dropless group, so a routing near-tie cannot move other
# tokens' capacity drops
MODEL_CHECKS = {
    "internlm2-20b": (2, 200, [200, 150]),
    "olmoe-1b-7b": (2, 128, [128, 100]),
    "qwen2-moe-a2.7b": (2, 128, [128, 100]),
    "nemotron-4-340b": (2, 64, [64, 40]),   # head_dim 192 in both attention kernels
}
# layers of a phase 4 check (2 unless named): one float32 nemotron-4-340b
# layer is 13.8 GB and its embedding and head 18.9 GB each, 51.5 GB on the
# card and again on the host (96 GiB)
MODEL_CHECK_LAYERS = {"nemotron-4-340b": 1}
SERVED = ("internlm2-20b", "olmoe-1b-7b", "qwen2-moe-a2.7b", "xlstm-1.3b", "zamba2-2.7b")
# phase 5: the longest prompt of a served request (from 64), by arch where
# it is not 1024: every xlstm-1.3b admission is a host loop of sLSTM
# launches (~3.7 ms a token), so its served prompts stay within 256 tokens;
# its profiled admission keeps 1024
SERVE_PROMPT_MAX = {"xlstm-1.3b": 256}
# phase 6: internlm2-20b through the port's ClusterServingEngine (thread
# workers x slots each, against one engine of as many slots): 8 requests
# fill every slot of both replicas once
CLUSTER = {"workers": 2, "slots": 4, "requests": 8, "new_tokens": 32}

# mLSTM: |kernel - plain| <= atol + rtol |plain| for h and for the final
# state.  float32 takes tests/test_kernels.py's tolerances for a kernel held
# against another chunking (the plain version shrinks the chunk to divide S,
# the kernel masks a ragged tail); a bfloat16 h is one rounding of an O(1)
# float32 value, one bf16 step above |2| being 1.6e-2, hence the GMM_TOL
# terms; the state is float32 from the same bf16 inputs on both sides.
MLSTM_TOL = {"h": {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 1e-2)},
             "state": {"float32": (5e-3, 1e-2), "bfloat16": (5e-3, 1e-2)}}
# (B, H, S, dk, dv, chunk, initial state, what); q and k are |N(0, 1)|, so
# every score is positive and h is a weighted mean of v rows (with signed
# scores a position whose denominator cancels to ~0 amplifies any rounding
# without bound); a state comes from the plain version on a 64-token prefix
MLSTM_CASES = [
    (1, 4, 1024, 512, 1024, 256, False, "xlstm-1.3b 1024-token admission"),
    (1, 4, 300, 512, 1024, 256, True, "ragged second chunk (256 + 44)"),
    (1, 4, 509, 512, 1024, 256, True, "prime length (256 + 253)"),
    (1, 4, 512, 512, 1024, 256, False, "xlstm-1.3b 512-token admission"),
    (2, 2, 200, 256, 256, 64, True, "B = 2, dk = dv = 256, chunks 3 x 64 + 8"),
    (3, 1, 37, 16, 32, 8, True, "small, BH = 3"),
]
XLSTM_CHECK = (8, 2, 300)   # layers (one 7:1 group), batch, prompt: 256 + 44 on the card
# xLSTM logits, float32 against a float64 run of the same model on the CPU.
# At full width the model's float32 logits lie a few 1e-3 from float64 and
# move by as much with the order of sums alone (the chunking), so 1e-3 card
# vs CPU would test rounding, not the kernel: the card is held within 1e-2
# of float64 and within 3x the float32 CPU run's own distance from it
XLSTM_LOGIT_ATOL, XLSTM_VS_CPU = 1e-2, 3.0

# SSD: |kernel - plain| <= atol + rtol |plain|, y as mLSTM's h (the plain
# version shrinks the chunk to divide S, the kernel masks a ragged tail; a
# bf16 y is one rounding of an O(1) float32 sum), the float32 state h
SSD_TOL = {"y": {"float32": (5e-4, 1e-3), "bfloat16": (2e-2, 1e-2)},
           "state": {"float32": (5e-3, 1e-2), "bfloat16": (5e-3, 1e-2)}}
# (B, S, H, G, chunk, initial state, views, what): N = P = 64; with views x,
# B and C are strided views of one (B, S, H*P + 2*G*N) conv output, as the
# Mamba2 block passes them; a state comes from the plain version on a
# 64-token prefix
SSD_CASES = [
    (1, 1024, 80, 1, 256, False, True, "zamba2-2.7b 1024-token admission"),
    (1, 300, 80, 1, 256, True, True, "ragged second chunk (256 + 44)"),
    (1, 509, 80, 1, 256, True, False, "prime length (256 + 253)"),
    (2, 200, 8, 2, 64, True, True, "B = 2, G = 2 (4 heads a group), chunks 3 x 64 + 8"),
    (1, 7, 8, 1, 256, False, False, "short prompt, one masked tile"),
]
ZAMBA2_CHECK = (12, 2, 300)   # layers (2 groups of 6), batch, prompt: 256 + 44 on the card
# phase 4 at the published depth (xlstm-1.3b's 48 layers, zamba2-2.7b's 54):
# batch, prompt and greedy decode steps, full width, float32 on the card and
# on the CPU beside a float64 CPU run (the rule of XLSTM_LOGIT_ATOL and
# XLSTM_VS_CPU); each side decodes the float64 run's greedy tokens
DEPTH_CHECK = (2, 16, 8)
# they run in a child process started before phase 8a and read after phase
# 9 (their CPU side, ~100 s of float64 and float32 inference, beside the
# card-bound phases), with DEPTH_THREADS of the host's cores
DEPTH_ARCHS = ("xlstm-1.3b", "zamba2-2.7b")
DEPTH_THREADS = 6
# internvl2-76b in phase 4: a float32 layer is 3.4 GB and the embedding and
# head 4.2 GB each, on the card and again on the host
VLM_CHECK_LAYERS = 2

# how phase 3 names each grouped-matmul route (kernels/grouped_matmul.py `route`)
GMM_ROUTES = {"wgmma": "TMA/wgmma", "stream": "TMA stream/mma.sync",
              "skinny": "skinny (CUDA cores)", "tiled": "tiled (CUDA cores)"}

KERNELS = {
    "decode_attention": {
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:32",
    },
    "flash_attention": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
    },
    # the two variants this repository's kernels added to the ported ones
    "flash_attention_window": {
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "variant": "causal sliding window (the reference model's causal_mask(window=))",
    },
    "decode_attention_q8": {
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:32",
        "variant": "int8 K/V with float32 per-vector scales (the reference's kv_quant cache)",
    },
    # the gradient of the flash kernel: the Pallas kernel has none (the
    # reference differentiates its plain attention through XLA)
    "flash_attention_backward": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:32",
        "variant": "backward (dq, dk, dv) of the flash kernel, for training on the card, from "
                   "the row log-sum-exp the forward saves; bf16 on the tensor cores (mma.sync), "
                   "float32 on the CUDA cores",
    },
    "grouped_matmul": {
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:27",
    },
    # the gradient of the grouped matmul: the Pallas kernel has none (the
    # reference differentiates its plain grouped matmul through XLA)
    "grouped_matmul_backward": {
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/grouped_matmul.py:27",
        "variant": "backward (dx = dy w^T, dw = x^T dy) of the grouped matmul, for training on "
                   "the card; bf16: the wgmma kernel reading x, w and dy in place through TMA "
                   "(no transposed copies), float32: the forward's tiled kernel on transposed "
                   "copies",
    },
    "mlstm": {
        "source": "src/repro_torch/kernels/csrc/mlstm.cu",
        "replaces": "src/repro/kernels/mlstm.py:34",
    },
    "mamba2_ssd": {
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:29",
    },
    # the gradients of the two chunked scans: the Pallas kernels have none
    # (the reference differentiates its plain chunked forms through XLA)
    "mlstm_backward": {
        "source": "src/repro_torch/kernels/csrc/mlstm_bwd.cu",
        "replaces": "src/repro/kernels/mlstm.py:34",
        "variant": "backward (dq, dk, dv, di, df) of the mLSTM kernel, for training on the card; "
                   "bf16 on the tensor cores (mma.sync, csrc/tile_bf16.cuh), float32 on the "
                   "CUDA cores (csrc/tile_f32.cuh)",
    },
    "mamba2_ssd_backward": {
        "source": "src/repro_torch/kernels/csrc/mamba2_ssd_bwd.cu",
        "replaces": "src/repro/kernels/mamba2_ssd.py:29",
        "variant": "backward (dx, ddt, dA, dB, dC, dD) of the SSD kernel, for training on the "
                   "card; bf16 on the tensor cores (mma.sync, csrc/tile_bf16.cuh: M and dCB "
                   "recomputed per tile in shared memory, dB and dC summed over head blocks), "
                   "float32 on the CUDA cores (csrc/tile_f32.cuh); gate passes a warp per chunk",
    },
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def _counter_modules():
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm

    # KERNELS name -> (module, counter); a variant's launches count in its
    # kernel's `launches` too
    return {"decode_attention": (dec, "launches"), "decode_attention_q8": (dec, "launches_q8"),
            "flash_attention": (fla, "launches"),
            "flash_attention_window": (fla, "launches_window"),
            "flash_attention_backward": (fla, "launches_backward"),
            "grouped_matmul": (gmm, "launches"),
            "grouped_matmul_backward": (gmm, "launches_backward"),
            "mlstm": (mlstm, "launches"),
            "mlstm_backward": (mlstm, "launches_backward"),
            "mamba2_ssd": (ssd, "launches"),
            "mamba2_ssd_backward": (ssd, "launches_backward")}


def zero_counts() -> None:
    """Every kernel wrapper's launch counter to 0: a run starts."""
    for module, counter in _counter_modules().values():
        setattr(module, counter, 0)


def read_counts() -> dict:
    """Every kernel's launches since :func:`zero_counts`, by KERNELS name."""
    return {name: getattr(module, counter)
            for name, (module, counter) in _counter_modules().items()}


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA events).

    The device first spins (``torch.cuda._sleep``) for 1.5x as long as the
    host took to run the ``reps`` calls once, at up to 2 GHz, so the host has
    enqueued them all before the start event: the events bracket the device's
    work alone.  Without the spin, a kernel that takes less time than its
    Python wrapper (the attention kernels at their serving shapes) would be
    timed at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(1.5 * host_s * 2e9))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_us(torch, fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` (microseconds, the mean over ``n``
    calls enqueued back to back): what a call costs a host-bound step."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_chunk_flops(S: int, chunk: int, dk: int, dv: int) -> int:
    """Operations of one (sequence, head) of a chunked causal scan over S
    positions in chunks of ``chunk`` (the last one ragged), as the function
    needs them: per chunk of n positions the score and score-times-value
    products on and below the diagonal, n(n+1)/2 x 2(dk + dv), and the
    state's read and update, 2n dk dv each."""
    ns = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    return sum(n * (n + 1) * (dk + dv) + 4 * n * dk * dv for n in ns)


def max_err(torch, a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def ptxas_summary(log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers line, spill line) for each kernel of an ``nvcc
    -Xptxas -v`` log, the kernel names demangled where ``c++filt`` exists."""
    rows, name, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            rows.append((name, line.split("Used", 1)[1].strip(), spill))
            name, spill = None, ""
    try:
        demangled = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                                   capture_output=True, text=True, timeout=60).stdout.split("\n")
        rows = [(d.replace("(anonymous namespace)::", "").split("(")[0], r, s)
                for d, (_, r, s) in zip(demangled, rows)]
    except (OSError, subprocess.SubprocessError):
        pass
    return rows



# -- phase 3: kernels against their plain versions ---------------------------


# the decode kernel's row log-sum-exp (``lse=``, what a sequence-split
# cache's shards merge by) against the plain one: |kernel - plain| <=
# LSE_ATOL (phase 8's flash LSE limit); (B, Hkv, qpk, S, d, dtype, lengths)
DECODE_LSE_CASES = [
    (8, 8, 6, 2048, 128, "bfloat16", [1, 2, 127, 128, 129, 2047, 2048, 5000]),
    (8, 8, 6, 2048, 128, "float32", [1, 2, 127, 128, 129, 2047, 2048, 5000]),
    (4, 16, 1, 1024, 128, "bfloat16", [1, 37, 511, 5000]),
    (2, 2, 3, 300, 80, "float32", [1, 300]),
    (8, 20, 1, 1500, 64, "bfloat16", [1, 4, 63, 64, 65, 700, 1499, 1500]),
    (2, 8, 12, 512, 192, "bfloat16", [33, 512]),
]


def check_decode_lse(torch) -> dict:
    """Phase 3: the decode kernel with its LSE output held against the
    plain LSE (and its output against the plain version, as without), then
    timed with the flag on and off in turns (off, on, on, off) at
    internlm2-20b's serving shape."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ops

    worst = 0.0
    for i, (B, Hkv, qpk, S, d, dt, lens) in enumerate(DECODE_LSE_CASES):
        (q, k, v, lengths), _, want = decode_case(torch, B, Hkv, qpk, S, d, dt, lens,
                                                  seed=300 + i)
        lse = torch.empty((B, Hkv * qpk), dtype=torch.float32, device=DEVICE)
        got = ops.decode_attention_bhsd(q, k, v, lengths, lse=lse)
        plain = dec.decode_attention_lse_plain(q.reshape(B, Hkv, qpk, d), k.transpose(1, 2),
                                               lengths).reshape(B, Hkv * qpk)
        err, out_err = max_err(torch, lse, plain), max_err(torch, got, want)
        worst = max(worst, err)
        print(f"decode_attention lse B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} {dt} "
              f"lengths={lens}: lse max_abs_err={err:.3g}, output {out_err:.3g}")
        check(err <= LSE_ATOL, f"decode_attention's lse disagrees with the plain one: {err}")
        check(out_err <= TOL[dt], f"decode_attention with lse= disagrees: {out_err}")
    B, Hkv, qpk, S, d = 8, 8, 6, 2048, 128
    (q, k, v, lengths), _, _ = decode_case(torch, B, Hkv, qpk, S, d, "bfloat16", [S] * B,
                                           seed=310)
    lse = torch.empty((B, Hkv * qpk), dtype=torch.float32, device=DEVICE)
    off = lambda: ops.decode_attention_bhsd(q, k, v, lengths)
    on = lambda: ops.decode_attention_bhsd(q, k, v, lengths, lse=lse)
    turns = [time_ms(torch, fn, 50) for fn in (off, on, on, off)]
    q4, kt = q.reshape(B, Hkv, qpk, d), k.transpose(1, 2)
    lse4 = lse.view(B, Hkv, qpk)
    plain_ms = time_ms(torch, lambda: dec.decode_attention_plain(q4, kt, v.transpose(1, 2),
                                                                 lengths, lse=lse4), 10)
    nbytes = 2 * q.numel() * 2 + 2 * B * S * Hkv * d * 2 + B * 4 + lse.numel() * 4
    rec = {"shape": f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} bfloat16, lengths={S}, with lse",
           "max_abs_err": worst, "ms": (turns[1] + turns[2]) / 2, "plain_ms": plain_ms,
           "library_ms": None, "library": "none: SDPA returns no row log-sum-exp",
           "lse_cost": {"no_lse_ms": (turns[0] + turns[3]) / 2,
                        "lse_ms": (turns[1] + turns[2]) / 2, "turns_ms": turns}}
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 4 * B * S * Hkv * qpk * d, "bfloat16")
    print(f"decode_attention lse at {rec['shape']}: off {rec['lse_cost']['no_lse_ms']:.4f} ms, "
          f"on {rec['ms']:.4f} ms (turns {[f'{t:.4f}' for t in turns]})")
    del q, k, v, lse
    release(torch)
    return rec


def decode_case(torch, B, Hkv, qpk, S, d, dtype, lengths, seed):
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, 1, Hkv * qpk, d, generator=g, device=DEVICE).to(dt)
    k = torch.randn(B, S, Hkv, d, generator=g, device=DEVICE).to(dt)   # model cache layout
    v = torch.randn(B, S, Hkv, d, generator=g, device=DEVICE).to(dt)
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    got = ops.decode_attention_bhsd(q, k, v, lens)
    want = decode_attention_plain(
        q.reshape(B, Hkv, qpk, d), k.transpose(1, 2), v.transpose(1, 2), lens
    ).reshape(B, 1, Hkv * qpk, d)
    torch.cuda.synchronize()
    return (q, k, v, lens), got, want


def q8_case(torch, B, Hkv, qpk, S, d, dtype, lengths, seed):
    """The int8 decode on a cache quantized as the model quantizes it
    (``layers._quantize_kv`` of N(0, 1) K/V), against its plain version."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_q8_plain
    from repro_torch.models.layers import _quantize_kv

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    q = torch.randn(B, 1, Hkv * qpk, d, generator=g, device=DEVICE).to(getattr(torch, dtype))
    (kq, ks), (vq, vs) = (_quantize_kv(torch.randn(B, S, Hkv, d, generator=g, device=DEVICE))
                          for _ in range(2))
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
    got = ops.decode_attention_q8_bhsd(q, kq, vq, ks, vs, lens)
    t = lambda a: a.transpose(1, 2)
    want = decode_attention_q8_plain(q.reshape(B, Hkv, qpk, d), t(kq), t(vq), t(ks), t(vs),
                                     lens).reshape(B, 1, Hkv * qpk, d)
    torch.cuda.synchronize()
    return (q, kq, vq, ks, vs, lens), got, want


def flash_case(torch, B, H, Hkv, S, d, dtype, causal, seed, window=None, Skv=None):
    """Flash on model-layout q (B, S, H, d) and k/v (B, Skv, Hkv, d) against
    its plain version; ``Skv`` != S is cross attention (non-causal)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.flash_attention import flash_attention_heads_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)
    Skv = S if Skv is None else Skv
    q = torch.randn(B, S, H, d, generator=g, device=DEVICE).to(dt)     # model layout
    k = torch.randn(B, Skv, Hkv, d, generator=g, device=DEVICE).to(dt)
    v = torch.randn(B, Skv, Hkv, d, generator=g, device=DEVICE).to(dt)
    got = ops.flash_attention_bhsd(q, k, v, causal=causal, window=window)
    want = flash_attention_heads_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=causal, window=window
    ).transpose(1, 2)
    torch.cuda.synchronize()
    return (q, k, v), got, want


def rotating(fn, items):
    """A call of ``fn`` on the next of ``items`` each time (cycling)."""
    state = {"i": 0}

    def call():
        fn(items[state["i"] % len(items)])
        state["i"] += 1
    return call


def window_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs a causal head attends: sum_i min(i + 1, window)."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def gmm_case(torch, E, C, d, f, dtype, seed, view=""):
    """x ~ N(0, 1) and w ~ N(0, 1) / sqrt(d), as ``moe_init`` scales them,
    so outputs are O(1); ``view`` as in GMM_CASES.  Returns ((x, w), kernel
    result, plain result)."""
    from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)
    dp, fp = (-(-d // 8) * 8, -(-f // 8) * 8) if view == "pad" else (d, f)
    x = torch.randn(E, C, dp, generator=g, device=DEVICE).to(dt)[..., :d]
    if view == "layer":
        w = (torch.randn(2, E, d, 2 * f, generator=g, device=DEVICE) / d**0.5).to(dt)[1, :, :, f:]
    else:
        w = (torch.randn(E, dp, fp, generator=g, device=DEVICE) / d**0.5).to(dt)[:, :d, :f]
    got = grouped_matmul(x, w)
    want = grouped_matmul_plain(x, w)
    torch.cuda.synchronize()
    return (x, w), got, want


def mlstm_case(torch, B, H, S, dk, dv, chunk, with_state, dtype, seed):
    """Model-layout inputs, as the xLSTM block hands them to the kernel: q,
    k (B, S, H, dk) and v (B, S, H, dv) in ``dtype``, the gates strided
    views of one (B, S, 2H) tensor.  Returns (inputs, state, kernel result,
    plain result), each result (h (B, S, H, dv), (C, n, m))."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mlstm import mlstm_chunked_heads_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)

    def inputs(T):
        q = torch.randn(B, T, H, dk, generator=g, device=DEVICE).abs().to(dt)
        k = torch.randn(B, T, H, dk, generator=g, device=DEVICE).abs().to(dt)
        v = torch.randn(B, T, H, dv, generator=g, device=DEVICE).to(dt)
        gates = torch.randn(B, T, 2 * H, generator=g, device=DEVICE)
        gates[..., H:] += 2.0   # forget gates near 1, as test_kernels draws them
        return (q, k, v, *gates.to(dt).chunk(2, dim=-1))

    def plain(xs, state):
        h, st = mlstm_chunked_heads_plain(*(x.transpose(1, 2) for x in xs), state, chunk=chunk)
        return h.transpose(1, 2), st

    state = plain(inputs(64), None)[1] if with_state else None
    xs = inputs(S)
    got = ops.mlstm_chunked(*xs, state, chunk=chunk)
    want = plain(xs, state)
    torch.cuda.synchronize()
    return xs, state, got, want


def ssd_inputs(torch, B, S, H, G, N, P, dtype, g, views):
    """x (B, S, H, P), Bm/Cm (B, S, G, N) in ``dtype``, ~ silu of N(0, 1) as
    the conv output is; dt (B, S, H) float32 = softplus(N(0, 1) + dt_bias)
    with dt_bias drawn as ``mamba2_block_init`` draws it, so decays are the
    model's; A = -linspace(1, 16, H) as the model's A_log gives; D ~ N(0, 1)."""
    import torch.nn.functional as F

    di = H * P
    if views:
        conv = F.silu(torch.randn(B, S, di + 2 * G * N, generator=g, device=DEVICE)).to(dtype)
        x = conv[..., :di].unflatten(-1, (H, P))
        Bm = conv[..., di:di + G * N].unflatten(-1, (G, N))
        Cm = conv[..., di + G * N:].unflatten(-1, (G, N))
    else:
        x, Bm, Cm = (F.silu(torch.randn(B, S, K, W, generator=g, device=DEVICE)).to(dtype)
                     for K, W in ((H, P), (G, N), (G, N)))
    u = torch.rand(H, generator=g, device=DEVICE)
    dt_bias = torch.log(torch.expm1(torch.exp(np.log(1e-3) + u * np.log(100.0))))
    dt = F.softplus(torch.randn(B, S, H, generator=g, device=DEVICE) + dt_bias)
    A = -torch.linspace(1.0, 16.0, H, device=DEVICE)
    D = torch.randn(H, generator=g, device=DEVICE)
    return x, dt, A, Bm, Cm, D


def ssd_case(torch, B, S, H, G, chunk, with_state, views, dtype, seed):
    """Returns (inputs, state, kernel result, plain result), each result
    (y (B, S, H, P), h (B, H, N, P))."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.mamba2_ssd import ssd_chunked_plain

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    tdt = getattr(torch, dtype)
    state = None
    if with_state:
        prefix = ssd_inputs(torch, B, 64, H, G, 64, 64, tdt, g, False)
        state = ssd_chunked_plain(*prefix, chunk=chunk)[1]
    xs = ssd_inputs(torch, B, S, H, G, 64, 64, tdt, g, views)
    got = ops.ssd_chunked(*xs, state, chunk=chunk)
    want = ssd_chunked_plain(*xs, state, chunk=chunk)
    torch.cuda.synchronize()
    return xs, state, got, want


MLSTM_PASSES = ("gates_kernel", "state_tc", "output_tc")
SSD_PASSES = ("chunk_state_tc", "combine_states", "output_tc")
# the mLSTM backward's kernels by route (csrc/mlstm_bwd.cu), as the profiler
# names them ("<" ends a templated name, so walk_fwd< is not walk_fwd_tc)
MLSTM_BWD_TC = ("gates_scan", "gates_exp", "prep_pos_tc", "walk_fwd_tc", "rows_num_tc",
                "prep_g_tc", "rows_dq_tc", "walk_bwd_tc", "dv_tc", "dk_tc", "gates_bwd")
MLSTM_BWD_CC = ("gates_scan", "gates_exp", "walk_fwd<", "p_tiles", "num<", "rows<", "g_fill",
                "ds_tiles", "walk_bwd<", "dq_tiles", "dk_tiles", "dv_tiles", "gates_bwd")


# the SSD backward's kernels by route (csrc/mamba2_ssd_bwd.cu)
SSD_BWD_TC = ("gates<", "walk_fwd_tc", "walk_bwd_tc", "rows_tc", "cols_tc", "gates_bwd",
              "reduce<")
SSD_BWD_CC = ("gates<", "walk_fwd<", "walk_bwd<", "cb_tiles", "dm_tiles", "dc_tiles", "db_tiles",
              "dx_tiles", "gates_bwd", "reduce<")
# the grouped-matmul backward's two wgmma products (bf16, in place)
GMM_BWD_PASSES = ("DxLayout", "DwLayout")

# the flash backward's kernels (csrc/flash_attention_bwd.cu), bf16 route
FLASH_BWD_PASSES = ("bwd_delta", "bwd_dkdv16", "bwd_group_sum", "bwd_dq16")


def passes_ms(torch, fn, passes, call_ms: float | None = None, calls: int = 3,
              windows: int = 4) -> dict:
    """Device ms per call of ``fn`` in each of its kernels whose name holds
    one of ``passes`` (torch.profiler over ``calls`` calls, every kernel).
    A window that recorded no device time, or whose kernels sum to less
    than 0.8 of ``call_ms`` (the call's CUDA-event time, where given), is
    run again: on the card, after many profiled windows in one process, the
    profiler at times records nothing or drops kernels.  A breakdown is
    informational, so after ``windows`` tries it is "not measured" rather
    than a failed run."""
    for _ in range(windows):
        try:
            top = profile_window(torch, fn, calls, top=32)["top_kernels_ms_per_call"]
        except RuntimeError as e:
            print(f"profiler window: {e}")
            continue
        out = {p: round(sum(ms for k, ms in top.items() if p in k), 4) for p in passes}
        if call_ms is None or sum(out.values()) >= 0.8 * call_ms:
            return out
        print(f"profiler window: kernels sum to {sum(out.values()):.4f} ms of a "
              f"{call_ms:.4f} ms call")
    return {p: "not measured" for p in passes}


def within(torch, got, want, tol, scale=1.0) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within atol x scale +
    rtol x |want|)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    return diff.max().item(), bool((diff <= atol * scale + rtol * want.float().abs()).all())


def check_kernels(torch) -> dict:
    """Phase 3.  Returns the timed record of each kernel at its serving shape."""
    import torch.nn.functional as F

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_heads_plain
    from repro_torch.kernels.grouped_matmul import grouped_matmul, grouped_matmul_plain

    print(f"tolerances: attention max |kernel - plain| <= {TOL} (float32 / bfloat16); "
          f"grouped_matmul |kernel - plain| <= atol + rtol |plain|, (atol, rtol) = {GMM_TOL}")
    full_lengths = [1, 2, 127, 128, 129, 2047, 2048, 5000]  # 1, S and >= S
    olmoe_lengths = [1, 129, 2048, 5000] * 2
    zamba2_lengths = [1, 2, 79, 80, 700, 2047, 2048, 5000]
    decode_cases = [
        (8, 8, 6, 2048, 128, dt, full_lengths) for dt in ("bfloat16", "float32")
    ] + [
        (8, 16, 1, 2048, 128, dt, olmoe_lengths) for dt in ("bfloat16", "float32")
    ] + [
        (3, 2, 4, 300, 64, dt, [1, 150, 300]) for dt in ("bfloat16", "float32")
    ] + [(2, 1, 8, 100, 32, "float32", [37, 100])] + [
        (8, 32, 1, 2048, 80, dt, zamba2_lengths) for dt in ("bfloat16", "float32")  # zamba2
    ] + [(2, 2, 3, 300, 80, "float32", [1, 300]), (2, 1, 8, 100, 32, "bfloat16", [37, 100])]
    # one case per cluster size: B * Hkv picked so that num_splits gives it,
    # lengths leaving some splits empty (1, 37, just under S / splits) and >= S
    for splits in dec.SPLITS:
        Hkv = max(1, dec.TARGET_BLOCKS // splits // 4)
        check(dec.num_splits(4 * Hkv) == splits, f"no B * Hkv gives {splits} splits")
        decode_cases += [(4, Hkv, 4, 1024, 128, dt, [1, 37, 1024 // splits - 1, 5000])
                         for dt in ("bfloat16", "float32")]
    # nemotron-4-340b's decode, head_dim 192 (96 heads over 8 kv heads)
    decode_cases += [(8, 8, 12, 2048, 192, dt, full_lengths) for dt in ("bfloat16", "float32")]
    # phase 6's replica shape (internlm2-20b, 4 slots): 4 splits at qpk 6,
    # lengths over its range (prompt 64..448 + 64 new tokens) and beyond
    decode_cases += [(4, 8, 6, 2048, 128, dt, lens) for dt in ("bfloat16", "float32")
                     for lens in ([1, 64, 449, 512], [513, 2047, 2048, 5000])]
    # whisper-large-v3's decoder: self and cross (1500 frames, no multiple
    # of a tile) attention at d 64, qpk 1
    whisper_lengths = [1, 4, 63, 64, 65, 700, 1499, 1500]
    decode_cases += [(8, 20, 1, 1500, 64, dt, whisper_lengths) for dt in ("bfloat16", "float32")]
    for i, (B, Hkv, qpk, S, d, dt, lens) in enumerate(decode_cases):
        _, got, want = decode_case(torch, B, Hkv, qpk, S, d, dt, lens, seed=i)
        err = max_err(torch, got, want)
        print(f"decode_attention B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} {dt} "
              f"lengths={lens} splits={dec.num_splits(B * Hkv)}: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"decode_attention disagrees with its plain version: {err}")
    decode_lse = check_decode_lse(torch)
    # the int8 variant: internlm2-20b's shape with ragged lengths, whisper's,
    # d 80 and 32, the largest group (qpk 16) and each cluster size
    q8_cases = [(8, 8, 6, 2048, 128, dt, full_lengths) for dt in ("bfloat16", "float32")] + [
        (8, 20, 1, 1500, 64, dt, whisper_lengths) for dt in ("bfloat16", "float32")] + [
        (3, 2, 4, 300, 80, "bfloat16", [1, 150, 300]), (2, 1, 8, 100, 32, "float32", [37, 100]),
        (4, 2, 16, 96, 64, "bfloat16", [96, 5, 33, 1])]
    for splits in dec.SPLITS:
        Hkv = max(1, dec.TARGET_BLOCKS // splits // 4)
        q8_cases.append((4, Hkv, 4, 1024, 128, "bfloat16", [1, 37, 1024 // splits - 1, 5000]))
    for i, (B, Hkv, qpk, S, d, dt, lens) in enumerate(q8_cases):
        _, got, want = q8_case(torch, B, Hkv, qpk, S, d, dt, lens, seed=50 + i)
        err = max_err(torch, got, want)
        print(f"decode_attention_q8 B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} {dt} int8 K/V "
              f"lengths={lens} splits={dec.num_splits(B * Hkv)}: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"decode_attention_q8 disagrees with its plain version: {err}")

    flash_cases = [
        (2, 48, 8, S, 128, dt, True) for S in (512, 1024) for dt in ("bfloat16", "float32")
    ] + [
        (1, 16, 16, 1024, 128, dt, True) for dt in ("bfloat16", "float32")  # olmoe, qpk=1
    ] + [
        (2, 48, 8, 512, 128, "bfloat16", False),
        (1, 48, 8, 333, 128, "bfloat16", True),   # a ragged prompt length
        (1, 48, 8, 333, 128, "float32", True),
        (2, 8, 2, 200, 64, "float32", True),
        (1, 4, 4, 96, 32, "float32", False),
    ] + [
        (1, 32, 32, S, 80, dt, True) for S in (1024, 333) for dt in ("bfloat16", "float32")
    ] + [  # zamba2's shared attention, d = 80; then bf16 at d = 64, 32 and d = 80 non-causal
        (2, 8, 2, 200, 64, "bfloat16", True),
        (1, 4, 4, 96, 32, "bfloat16", False),
        (1, 4, 4, 96, 32, "bfloat16", True),
        (1, 32, 32, 333, 80, "bfloat16", False),
    ] + [  # nemotron-4-340b's prefill, head_dim 192; a ragged length, non-causal
        (1, 96, 8, 1024, 192, dt, True) for dt in ("bfloat16", "float32")
    ] + [(1, 96, 8, 333, 192, "bfloat16", True), (1, 16, 8, 200, 192, "float32", False)]
    for i, (B, H, Hkv, S, d, dt, causal) in enumerate(flash_cases):
        _, got, want = flash_case(torch, B, H, Hkv, S, d, dt, causal, seed=100 + i)
        err = max_err(torch, got, want)
        print(f"flash_attention B={B} H={H} Hkv={Hkv} S={S} d={d} {dt} "
              f"causal={causal}: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"flash_attention disagrees with its plain version: {err}")
    # the window variant (zamba2's shape at both timed sizes; windows whose
    # edge falls inside a key tile, of 1 key, or wider than S) and whisper's
    # non-causal encoder and cross attention (Sq != Skv = 1500, d 64)
    window_cases = [(1, 32, 32, 1024, 256, 80, dt) for dt in ("bfloat16", "float32")] + [
        (1, 32, 32, 8192, 4096, 80, "bfloat16"), (1, 32, 32, 333, 100, 80, "float32"),
        (2, 8, 2, 257, 65, 64, "bfloat16"), (1, 48, 8, 300, 7, 128, "bfloat16"),
        (1, 4, 4, 200, 1, 32, "bfloat16"), (2, 8, 2, 130, 500, 64, "float32")]
    for i, (B, H, Hkv, S, W, d, dt) in enumerate(window_cases):
        _, got, want = flash_case(torch, B, H, Hkv, S, d, dt, True, seed=150 + i, window=W)
        err = max_err(torch, got, want)
        print(f"flash_attention_window B={B} H={H} Hkv={Hkv} S={S} window={W} d={d} {dt}: "
              f"max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"flash_attention_window disagrees with its plain version: {err}")
    cross_cases = [(1, 20, 20, 448, 1500, dt) for dt in ("bfloat16", "float32")] + [
        (8, 20, 20, 4, 1500, "bfloat16"), (8, 20, 20, 1500, 1500, "bfloat16")]
    for i, (B, H, Hkv, S, Skv, dt) in enumerate(cross_cases):
        _, got, want = flash_case(torch, B, H, Hkv, S, 64, dt, False, seed=170 + i, Skv=Skv)
        err = max_err(torch, got, want)
        print(f"flash_attention B={B} H={H} Hkv={Hkv} Sq={S} Skv={Skv} d=64 {dt} "
              f"non-causal: max_abs_err={err:.3g}")
        check(err <= TOL[dt], f"flash_attention (Sq != Skv) disagrees with its plain version: "
                              f"{err}")

    for i, (E, C, d, f, view, what) in enumerate(GMM_CASES):
        for dt in ("bfloat16", "float32"):
            (x, w), got, want = gmm_case(torch, E, C, d, f, dt, seed=200 + i, view=view)
            err, ok = within(torch, got, want, GMM_TOL[dt])
            print(f"grouped_matmul ({E},{C},{d})x({E},{d},{f}) {dt} {what}: route "
                  f"{GMM_ROUTES[gmm.route(x, w)]}, max_abs_err={err:.3g}, "
                  f"within (atol, rtol)={GMM_TOL[dt]}: {ok}")
            check(ok, f"grouped_matmul disagrees with its plain version: {err}")

    print(f"mlstm |kernel - plain| <= atol + rtol |plain|, (atol, rtol) = {MLSTM_TOL}")
    for i, (B, H, S, dk, dv, chunk, with_state, what) in enumerate(MLSTM_CASES):
        for dt in ("bfloat16", "float32"):
            xs, _, (h, st), (hp, stp) = mlstm_case(torch, B, H, S, dk, dv, chunk, with_state,
                                                   dt, seed=300 + i)
            err_h, ok_h = within(torch, h, hp, MLSTM_TOL["h"][dt])
            errs = [within(torch, a, b, MLSTM_TOL["state"][dt]) for a, b in zip(st, stp)]
            print(f"mlstm B={B} H={H} S={S} dk={dk} dv={dv} chunk={chunk} {dt} {what}, route "
                  f"{mlstm.route(xs[0], xs[2]).replace('_', ' ')}"
                  f"{', initial state' if with_state else ''}: max_abs_err h={err_h:.3g} "
                  f"C={errs[0][0]:.3g} n={errs[1][0]:.3g} m={errs[2][0]:.3g}, within: "
                  f"{ok_h and all(ok for _, ok in errs)}")
            check(ok_h and all(ok for _, ok in errs),
                  f"mlstm disagrees with its plain version: h {err_h}, state {errs}")

    print(f"mamba2_ssd |kernel - plain| <= atol + rtol |plain|, (atol, rtol) = {SSD_TOL}")
    for i, (B, S, H, G, chunk, with_state, views, what) in enumerate(SSD_CASES):
        for dt in ("bfloat16", "float32"):
            xs, _, (y, h), (yp, hp) = ssd_case(torch, B, S, H, G, chunk, with_state, views, dt,
                                               seed=400 + i)
            err_y, ok_y = within(torch, y, yp, SSD_TOL["y"][dt])
            err_h, ok_h = within(torch, h, hp, SSD_TOL["state"][dt])
            print(f"mamba2_ssd B={B} S={S} H={H} G={G} N=P=64 chunk={chunk} {dt} {what}, route "
                  f"{ssd.route(xs[0]).replace('_', ' ')}"
                  f"{', initial state' if with_state else ''}"
                  f"{', conv-output views' if views else ''}: max_abs_err y={err_y:.3g} "
                  f"h={err_h:.3g}, within: {ok_y and ok_h}")
            check(ok_y and ok_h, f"mamba2_ssd disagrees with its plain version: y {err_y}, "
                                 f"h {err_h}")

    records = {"decode_attention_lse": decode_lse}
    # decode at the serving shapes, whole cache valid (the 2048-position
    # bound): internlm2-20b, olmoe-1b-7b, and zamba2-2.7b's shared block at d = 80
    for key, (B, Hkv, qpk, S, d) in (("decode_attention", (8, 8, 6, 2048, 128)),
                                     ("decode_attention_olmoe", (8, 16, 1, 2048, 128)),
                                     ("decode_attention_zamba2", (8, 32, 1, 2048, 80))):
        (q, k, v, lens), got, want = decode_case(
            torch, B, Hkv, qpk, S, d, "bfloat16", [S] * B, seed=7)
        H, es = Hkv * qpk, 2
        nbytes = 2 * q.numel() * es + 2 * int(lens.sum()) * Hkv * d * es + lens.numel() * 4
        flops = 4 * int(lens.sum()) * H * d
        q4, kt, vt = q.reshape(B, Hkv, qpk, d), k.transpose(1, 2), v.transpose(1, 2)
        mask = (torch.arange(S, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]
        qs = q.transpose(1, 2)   # (B, H, 1, d)
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: ops.decode_attention_bhsd(q, k, v, lens), 50),
            plain_ms=time_ms(torch, lambda: decode_attention_plain(q4, kt, vt, lens), 20),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kt, vt, attn_mask=mask, enable_gqa=True), 50),
            shape=f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} bfloat16, lengths={S}, "
                  f"splits={dec.num_splits(B * Hkv)}",
            library="sdpa",
            # the evidence for num_splits: the kernel at every cluster size
            ms_by_splits={s: time_ms(torch, lambda s=s: dec._launch(q4, kt, vt, lens, splits=s),
                                     50) for s in dec.SPLITS},
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, "bfloat16")

    # nemotron-4-340b's decode at head_dim 192 (qpk 12), whole cache valid,
    # in both dtypes: the d 192 build is new, and float32 runs on the CUDA cores
    for key, dt in (("decode_attention_d192", "bfloat16"), ("decode_attention_d192_f32",
                                                              "float32")):
        B, Hkv, qpk, S, d = 8, 8, 12, 2048, 192
        (q, k, v, lens), got, want = decode_case(torch, B, Hkv, qpk, S, d, dt, [S] * B, seed=7)
        es = q.element_size()
        nbytes = 2 * q.numel() * es + 2 * int(lens.sum()) * Hkv * d * es + lens.numel() * 4
        flops = 4 * int(lens.sum()) * Hkv * qpk * d
        q4, kt, vt = q.reshape(B, Hkv, qpk, d), k.transpose(1, 2), v.transpose(1, 2)
        qs = q.transpose(1, 2)
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: ops.decode_attention_bhsd(q, k, v, lens), 50),
            plain_ms=time_ms(torch, lambda: decode_attention_plain(q4, kt, vt, lens), 20),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kt, vt, enable_gqa=True), 50),
            shape=f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} {dt}, lengths={S}, "
                  f"splits={dec.num_splits(B * Hkv)}",
            library="sdpa",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, dt)

    # flash at the largest admission prefill, one prompt of 1024 tokens:
    # internlm2-20b, olmoe-1b-7b, and zamba2-2.7b's shared block at d = 80
    for key, (B, H, Hkv, S, d) in (("flash_attention", (1, 48, 8, 1024, 128)),
                                   ("flash_attention_olmoe", (1, 16, 16, 1024, 128)),
                                   ("flash_attention_zamba2", (1, 32, 32, 1024, 80))):
        (q, k, v), got, want = flash_case(torch, B, H, Hkv, S, d, "bfloat16", True, seed=8)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4 * B * H * d * (S * (S + 1) // 2)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: ops.flash_attention_bhsd(q, k, v, causal=True), 20),
            plain_ms=time_ms(torch, lambda: flash_attention_heads_plain(qh, kh, vh, causal=True),
                             10),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True), 20),
            shape=f"B={B} H={H} Hkv={Hkv} S={S} d={d} bfloat16 causal",
            library="sdpa",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, "bfloat16")

    # nemotron-4-340b's prefill at head_dim 192, one prompt of 1024 tokens,
    # in both dtypes
    for key, dt in (("flash_attention_d192", "bfloat16"), ("flash_attention_d192_f32",
                                                             "float32")):
        B, H, Hkv, S, d = 1, 96, 8, 1024, 192
        (q, k, v), got, want = flash_case(torch, B, H, Hkv, S, d, dt, True, seed=8)
        nbytes = q.element_size() * (q.numel() + k.numel() + v.numel() + q.numel())
        flops = 4 * B * H * d * (S * (S + 1) // 2)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: ops.flash_attention_bhsd(q, k, v, causal=True), 20),
            plain_ms=time_ms(torch, lambda: flash_attention_heads_plain(qh, kh, vh, causal=True),
                             5),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True), 20),
            shape=f"B={B} H={H} Hkv={Hkv} S={S} d={d} {dt} causal",
            library="sdpa",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, dt)

    # the window variant at zamba2's shape, S 8192 with W 4096 (the
    # long-context cell's window) and S 1024 with W 256, each beside the
    # causal call at the same shape: a kernel that skips the tiles left of
    # the window does sum_i min(i + 1, W) / sum_i (i + 1) of the causal
    # work (0.75 at S 8192), one that only masked them would take >= 1x
    for key, (S, W) in (("flash_attention_window", (8192, 4096)),
                        ("flash_attention_window_s1024", (1024, 256))):
        B, H, Hkv, d = 1, 32, 32, 80
        (q, k, v), got, want = flash_case(torch, B, H, Hkv, S, d, "bfloat16", True, seed=13,
                                          window=W)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * B * H * d * window_pairs(S, W)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = torch.ones(S, S, dtype=torch.bool, device=DEVICE).tril().triu(1 - W)
        # windowed and causal in turns (causal, window, window, causal), the
        # better of each pair, so that a clock change between them cannot
        # pass for the skipped tiles
        windowed = lambda: ops.flash_attention_bhsd(q, k, v, causal=True, window=W)
        causal = lambda: ops.flash_attention_bhsd(q, k, v, causal=True)
        reps = 20
        turns = [time_ms(torch, fn, reps) for fn in (causal, windowed, windowed, causal)]
        rec = dict(
            max_abs_err=max_err(torch, got, want),
            ms=min(turns[1:3]),
            plain_ms=time_ms(torch, lambda: flash_attention_heads_plain(
                qh, kh, vh, causal=True, window=W), 3 if S > 4096 else 10),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True), reps),
            causal_ms=min(turns[0], turns[3]),
            turns_ms=turns,
            shape=f"B={B} H={H} Hkv={Hkv} S={S} window={W} d={d} bfloat16",
            library="sdpa (boolean window mask)",
        )
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, "bfloat16")
        rec["causal_bound_ms"] = bound(nbytes, 4 * B * H * d * window_pairs(S, None),
                                       "bfloat16")[0]
        rec["window_over_causal"] = rec["ms"] / rec["causal_ms"]
        records[key] = rec
        print(f"{key}: windowed {rec['ms']:.4f} ms, causal {rec['causal_ms']:.4f} ms "
              f"(turns causal, window, window, causal: {[f'{t:.4f}' for t in turns]})")
        del q, k, v, got, want, qh, kh, vh, mask
        release(torch)
    check(records["flash_attention_window"]["window_over_causal"] < 0.9,
          f"windowed flash at S 8192 / W 4096 takes "
          f"{records['flash_attention_window']['window_over_causal']:.3f}x the causal call: "
          f"the tiles left of the window are not skipped")

    # whisper-large-v3's flash calls: the encoder (8 x 1500 frames) and the
    # decoder's cross attention of a 448-token prefill over 1500 frames,
    # both non-causal at d 64
    for key, (B, S, Skv) in (("flash_attention_whisper_encoder", (8, 1500, 1500)),
                             ("flash_attention_whisper_cross", (1, 448, 1500))):
        (q, k, v), got, want = flash_case(torch, B, 20, 20, S, 64, "bfloat16", False, seed=14,
                                          Skv=Skv)
        qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: ops.flash_attention_bhsd(q, k, v, causal=False), 20),
            plain_ms=time_ms(torch, lambda: flash_attention_heads_plain(qh, kh, vh,
                                                                        causal=False), 5),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh), 20),
            shape=f"B={B} H=20 Hkv=20 Sq={S} Skv={Skv} d=64 bfloat16 non-causal",
            library="sdpa",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(
            2 * (2 * q.numel() + k.numel() + v.numel()), 4 * B * 20 * 64 * S * Skv, "bfloat16")

    # decode at whisper-large-v3's cross attention: 8 sequences, 20 kv heads
    # of d 64, qpk 1, every one of the 1500 frames attended
    B, Hkv, qpk, S, d = 8, 20, 1, 1500, 64
    (q, k, v, lens), got, want = decode_case(torch, B, Hkv, qpk, S, d, "bfloat16", [S] * B,
                                             seed=15)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    records["decode_attention_whisper"] = dict(
        max_abs_err=max_err(torch, got, want),
        ms=time_ms(torch, lambda: ops.decode_attention_bhsd(q, k, v, lens), 50),
        plain_ms=time_ms(torch, lambda: decode_attention_plain(
            q.reshape(B, Hkv, qpk, d), kt, vt, lens), 20),
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), kt, vt), 50),
        shape=f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} bfloat16, lengths={S}, "
              f"splits={dec.num_splits(B * Hkv)}",
        library="sdpa",
    )
    records["decode_attention_whisper"]["bound_ms"], \
        records["decode_attention_whisper"]["bound_by"] = bound(
            2 * q.numel() * 2 + 2 * B * S * Hkv * d * 2 + B * 4, 4 * B * S * Hkv * qpk * d,
            "bfloat16")

    # the int8 variant at internlm2-20b's serving shape: ragged lengths (the
    # run's bound counts the keys they make valid), and the whole cache
    # valid, each beside the bf16 kernel on the dequantized cache and SDPA
    # over it (a yardstick: SDPA reads the dequantized bf16 cache).  The
    # int8 cache (34 MB) fits the 50 MB L2, so kernel and bf16 kernel each
    # cycle through 4 copies of their cache, as a decode step's layers do:
    # every call finds its cache cold
    from repro_torch.kernels.decode_attention import decode_attention_q8_plain
    from repro_torch.kernels.ref import dequantize_kv

    B, Hkv, qpk, S, d = 8, 8, 6, 2048, 128
    for key, lengths in (("decode_attention_q8", full_lengths),
                         ("decode_attention_q8_full", [S] * B)):
        (q, kq, vq, ks, vs, lens), got, want = q8_case(torch, B, Hkv, qpk, S, d, "bfloat16",
                                                       lengths, seed=16)
        kd, vd = dequantize_kv(kq, ks, q.dtype), dequantize_kv(vq, vs, q.dtype)
        t = lambda a: a.transpose(1, 2)
        valid = int(lens.clamp(max=S).sum())
        nbytes = 2 * q.numel() * 2 + 2 * valid * Hkv * (d + 4) + B * 4
        mask = (torch.arange(S, device=DEVICE)[None, :] < lens[:, None])[:, None, None, :]
        q8s = [(kq, vq, ks, vs)] + [tuple(x.clone() for x in (kq, vq, ks, vs)) for _ in range(3)]
        bf16s = [(kd, vd)] + [(kd.clone(), vd.clone()) for _ in range(3)]
        records[key] = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, rotating(lambda c: ops.decode_attention_q8_bhsd(q, *c, lens), q8s),
                       48),
            plain_ms=time_ms(torch, lambda: decode_attention_q8_plain(
                q.reshape(B, Hkv, qpk, d), t(kq), t(vq), t(ks), t(vs), lens), 20),
            library_ms=time_ms(torch, rotating(lambda c: F.scaled_dot_product_attention(
                q.transpose(1, 2), t(c[0]), t(c[1]), attn_mask=mask, enable_gqa=True), bf16s),
                48),
            bf16_ms=time_ms(torch, rotating(lambda c: ops.decode_attention_bhsd(q, *c, lens),
                                            bf16s), 48),
            caches_cycled=len(q8s),
            shape=f"B={B} Hkv={Hkv} qpk={qpk} S={S} d={d} bfloat16 q, int8 K/V, "
                  f"lengths={lengths}, splits={dec.num_splits(B * Hkv)}",
            library="sdpa over the dequantized bf16 cache",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(
            nbytes, 4 * valid * Hkv * qpk * d, "bfloat16")
        records[key]["bf16_bound_ms"] = bound(
            2 * q.numel() * 2 + 2 * valid * Hkv * d * 2 + B * 4, 4 * valid * Hkv * qpk * d,
            "bfloat16")[0]
        # each cluster size on the same caches, and what the launch holds:
        # ptxas's registers and the shared memory and blocks an SM
        q4 = q.reshape(B, Hkv, qpk, d)
        records[key]["ms_by_splits"] = {
            s: time_ms(torch, rotating(lambda c, s=s: dec._launch(
                q4, t(c[0]), t(c[1]), lens, splits=s, scales=(t(c[2]), t(c[3]))), q8s), 48)
            for s in dec.SPLITS}
        records[key].update(dec.q8_resources(d, torch.bfloat16, q.device.index))
        records[key]["ptxas"] = next((f"{regs}; {spill}" for kernel, regs, spill in ptxas_summary(
            _build.build_logs.get("decode_attention", "")) if f"decode_q8_bf16<{d}>" in kernel),
            None)

    # grouped matmul at GMM_TIMED's shapes; a call streams 134-268 MB of
    # weights, more than the 50 MB L2, so every call finds w cold
    for regime, (E, C, d, f) in GMM_TIMED.items():
        (x, w), got, want = gmm_case(torch, E, C, d, f, "bfloat16", seed=9)
        nbytes = 2 * (x.numel() + w.numel() + E * C * f)
        flops = 2 * E * C * d * f
        rec = dict(
            max_abs_err=max_err(torch, got, want),
            ms=time_ms(torch, lambda: grouped_matmul(x, w), 20),
            plain_ms=time_ms(torch, lambda: grouped_matmul_plain(x, w), 10),
            library_ms=time_ms(torch, lambda: torch.bmm(x, w), 20),
            shape=f"({E},{C},{d})x({E},{d},{f}) bfloat16, route {GMM_ROUTES[gmm.route(x, w)]}",
            library="torch.bmm",
        )
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, "bfloat16")
        # the host time of a call (a decode step is host-bound; the prefill
        # route encodes x's tensor map on every call)
        rec["host_us"] = host_us(torch, lambda: grouped_matmul(x, w))
        records["grouped_matmul" if regime == "decode" else f"grouped_matmul_{regime}"] = rec

    # mLSTM at xlstm-1.3b admissions of 1024 and 512 tokens, empty state; the
    # work is what the function needs per (sequence*head, chunk of n
    # positions): q.k^T and scores.v on and below the diagonal, n(n+1)/2 x
    # 2(dk + dv), q.C 2n dk dv and the C update 2n dk dv
    from repro_torch.kernels.mlstm import mlstm_chunked_heads_plain

    for key, case in (("mlstm", MLSTM_CASES[0]), ("mlstm_s512", MLSTM_CASES[3])):
        B, H, S, dk, dv, chunk, _, _ = case
        xs, _, (h, _), (hp, _) = mlstm_case(torch, B, H, S, dk, dv, chunk, False, "bfloat16",
                                            seed=10)
        flops = B * H * causal_chunk_flops(S, chunk, dk, dv)
        nbytes = 2 * (2 * B * S * H * dk + 2 * B * S * H * dv + 2 * B * S * H) + 4 * B * H * (
            dk * dv + dk + 1)
        heads = [x.transpose(1, 2) for x in xs]
        records[key] = dict(
            max_abs_err=max_err(torch, h, hp),
            ms=time_ms(torch, lambda: ops.mlstm_chunked(*xs, chunk=chunk), 20),
            plain_ms=time_ms(torch, lambda: mlstm_chunked_heads_plain(*heads, chunk=chunk), 5),
            library_ms=None,
            shape=f"B={B} H={H} S={S} dk={dk} dv={dv} chunk={chunk} bfloat16, empty state, "
                  f"route {mlstm.route(xs[0], xs[2]).replace('_', ' ')}",
            library="none: no single PyTorch call computes mLSTM",
        )
        records[key]["bound_ms"], records[key]["bound_by"] = bound(nbytes, flops, "bfloat16")
        records[key]["previous"] = {"route": "cuda cores", "ms": time_ms(   # same inputs
            torch, lambda: mlstm._launch(*heads, None, chunk, None, kernel="cuda_cores"), 20)}
        records[key]["passes_ms"] = passes_ms(
            torch, lambda: ops.mlstm_chunked(*xs, chunk=chunk), MLSTM_PASSES,
            records[key]["ms"], calls=10, windows=3)
    # the evidence for the state pass's walk: at B 1, H 4, S 1024 it runs
    # 128 blocks (one per 128 x 128 tile of C, B*H = 4) that each walk the 4
    # chunks in order; a chunk-parallel grid (one block per tile and chunk)
    # would run 512 blocks of one chunk each, the grid B 4, H 4, S 256 gives,
    # plus an in-order combine pass over the 4 chunks' float32 updates
    xs = mlstm_case(torch, 4, 4, 256, 512, 1024, 256, False, "bfloat16", seed=12)[0]
    records["mlstm"]["passes_ms"]["state_tc, 512 blocks of one chunk (B 4, H 4, S 256)"] = (
        passes_ms(torch, lambda: ops.mlstm_chunked(*xs, chunk=256), MLSTM_PASSES, calls=10,
                  windows=3)["state_tc"])

    # SSD at zamba2-2.7b admissions of 512, 1024 and 2048 tokens (the served
    # prompt range up to max_len), empty state, x/B/C views of one conv
    # output as the block passes them; the work is what the function needs
    # per (sequence*head, chunk of n positions): C.B^T and scores.x on and
    # below the diagonal, n(n+1)/2 x 2(N + P), C.h 2n N P and the h update
    # 2n N P; the bytes are x, B, C, dt, A and D read once, y and the final h
    # written once
    B, _, H, G, chunk, _, _, _ = SSD_CASES[0]
    N = P = 64
    for key, S in (("mamba2_ssd", 1024), ("mamba2_ssd_s512", 512), ("mamba2_ssd_s2048", 2048)):
        xs, _, (y, _), (yp, _) = ssd_case(torch, B, S, H, G, chunk, False, True, "bfloat16",
                                          seed=11)
        flops = B * H * causal_chunk_flops(S, chunk, N, P)
        nbytes = 2 * (2 * B * S * H * P + 2 * B * S * G * N) + 4 * (
            B * S * H + 2 * H + B * H * N * P)
        rec = dict(
            max_abs_err=max_err(torch, y, yp),
            ms=time_ms(torch, lambda: ops.ssd_chunked(*xs, chunk=chunk), 20),
            plain_ms=time_ms(torch, lambda: ssd.ssd_chunked_plain(*xs, chunk=chunk), 5),
            library_ms=None,
            shape=f"B={B} S={S} H={H} G={G} N=P=64 chunk={chunk} bfloat16, empty state, "
                  f"route {ssd.route(xs[0]).replace('_', ' ')}",
            library="none: no single PyTorch call computes SSD",
        )
        rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, "bfloat16")

        def previous(xs=xs):   # the replaced route on the same inputs
            return ssd._launch(*xs, None, chunk, kernel="cuda_cores")

        rec["previous"] = {"route": "cuda cores", "ms": time_ms(torch, previous, 20)}
        rec["passes_ms"] = passes_ms(torch, lambda: ops.ssd_chunked(*xs, chunk=chunk),
                                     SSD_PASSES, rec["ms"], calls=10, windows=3)
        # the host time of a call (a zamba2 admission makes 54), beside the
        # replaced route's single launch without scratch
        rec["host_us"] = host_us(torch, lambda: ops.ssd_chunked(*xs, chunk=chunk))
        rec["previous"]["host_us"] = host_us(torch, previous)
        records[key] = rec
    for name, rec in records.items():
        lib = "n/a" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
        print(f"{name} timed at {rec['shape']}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, {rec['library']} {lib}, "
              f"bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        if "ms_by_splits" in rec:
            print(f"{name} ms by cluster size (splits): " + ", ".join(
                f"{s}: {ms:.4f}" for s, ms in rec["ms_by_splits"].items()))
        if "host_us" in rec:
            print(f"{name} host per call {rec['host_us']:.1f} us")
        if "passes_ms" in rec:   # a pass is "not measured" where the profiler fell short
            print(f"{name} device ms per call by pass: " + ", ".join(
                f"{p}: {ms:.4f}" if isinstance(ms, float) else f"{p}: {ms}"
                for p, ms in rec["passes_ms"].items()))
        if "causal_ms" in rec:
            print(f"{name} causal call at the same shape {rec['causal_ms']:.4f} ms (bound "
                  f"{rec['causal_bound_ms']:.4f}): windowed / causal "
                  f"{rec['window_over_causal']:.3f}")
        if "bf16_ms" in rec:
            print(f"{name} bf16 kernel on the dequantized cache {rec['bf16_ms']:.4f} ms "
                  f"(bound {rec['bf16_bound_ms']:.4f}); kernel, bf16 kernel and sdpa each "
                  f"cycled through {rec['caches_cycled']} copies of their cache; launch: "
                  f"{rec['ptxas']}, {rec['smem_bytes']} bytes of shared memory, "
                  f"{rec['blocks_per_sm']} block(s) an SM")
        if "previous" in rec:
            prev = rec["previous"]
            print(f"{name} previous route {prev['route']}: {prev['ms']:.4f} ms"
                  + (f", host per call {prev['host_us']:.1f} us" if "host_us" in prev else ""))
    return records


# -- phase 4: model checks against the plain path on the CPU -----------------


class RouteLog:
    """Records each MoE layer's routing (CPU copies of the float32 probs
    and the chosen experts) into ``self.calls`` while installed."""

    def __init__(self):
        self.calls = None

    def __enter__(self):
        from repro_torch.models import moe

        self._moe, self._route = moe, moe.route

        def route(x, router, cfg, tokens_per_group=4096):
            out = self._route(x, router, cfg, tokens_per_group)
            if self.calls is not None:
                self.calls.append((out[0].detach().cpu(), out[2].detach().cpu()))
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        self._moe.route = self._route


def routing_diff(calls_card, calls_cpu, k, T):
    """Compare the card's and the CPU's routing call by call.  Returns the
    smallest top-k margin (CPU probs), the (sequence, position) of every
    token whose expert set differs, and the margins of those tokens."""
    check(len(calls_card) == len(calls_cpu), "card and CPU made different MoE calls")
    min_margin, flipped, margins = float("inf"), [], []
    for (_, e_card), (probs, e_cpu) in zip(calls_card, calls_cpu):
        p = probs.reshape(-1, probs.shape[-1]).sort(dim=-1, descending=True).values
        margin = p[:, k - 1] - p[:, k]
        min_margin = min(min_margin, margin.min().item())
        differ = (e_card.reshape(-1, k).sort(-1).values
                  != e_cpu.reshape(-1, k).sort(-1).values).any(-1)
        for n in differ.nonzero().flatten().tolist():
            flipped.append(divmod(n, T))
            margins.append(margin[n].item())
    return min_margin, flipped, margins


def check_model(torch, arch: str) -> None:
    """Phase 4: one config at full width cut to 2 layers (or
    ``MODEL_CHECK_LAYERS``), float32, prefill +
    4 per-slot decode steps on the card against the plain path on the CPU.
    MoE tokens routed differently on the two sides must be near-ties; the
    positions they reach (later positions of the same sequence, and that
    lane's decode steps) are left out of the logit comparison."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 products on both sides
    torch.backends.cudnn.allow_tf32 = False
    layers = MODEL_CHECK_LAYERS.get(arch, 2)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers,
                              param_dtype="float32", dtype="float32")
    k = cfg.moe.top_k if cfg.moe else 0
    gpu, cpu = build_model(cfg, device=DEVICE), build_model(cfg, device="cpu")
    p_gpu = gpu.init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    rng = np.random.default_rng(0)
    B, T, pos0 = MODEL_CHECKS[arch]
    max_len = T + 56
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    taint = torch.zeros(B, T, dtype=torch.bool)   # positions a routing flip reaches
    lane_taint = torch.zeros(B, dtype=torch.bool)
    min_margin, flips, flip_margins = float("inf"), [], []
    log = RouteLog()

    def both(run_card, run_cpu, t):
        """Run one call on each side; returns both results and the
        (sequence, position) of every token routed differently."""
        nonlocal min_margin
        with log:
            log.calls = []
            out_card = run_card()
            calls_card, log.calls = log.calls, []
            out_cpu = run_cpu()
        if not cfg.moe:
            return out_card, out_cpu, []
        m, fl, mg = routing_diff(calls_card, log.calls, k, t)
        min_margin = min(min_margin, m)
        flips.extend(fl)
        flip_margins.extend(mg)
        return out_card, out_cpu, fl

    (lg, cg), (lc, cc), fl = both(lambda: gpu.prefill(p_gpu, {"tokens": tokens.to(DEVICE)}),
                                  lambda: cpu.prefill(p_cpu, {"tokens": tokens}), T)
    for b, t in fl:
        taint[b, t:] = True
        lane_taint[b] = True
    keep = ~taint
    errs = [max_err(torch, lg.cpu()[keep], lc[keep]),
            max_err(torch, cg["k"].cpu()[:, keep], cc["k"][:, keep])]
    cache_g, cache_c = gpu.init_cache(B, max_len), cpu.init_cache(B, max_len)
    for name in ("k", "v"):
        cache_g[name][:, :, :T] = cg[name]
        cache_c[name][:, :, :T] = cc[name]
    pos = np.array(pos0)  # lane 1 decodes as if its prompt were shorter
    for _ in range(4):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        (lg, _), (lc, _), fl = both(
            lambda: gpu.decode_step(p_gpu, cache_g, {"tokens": torch.from_numpy(step).to(DEVICE),
                                                     "pos": torch.from_numpy(pos).to(DEVICE)}),
            lambda: cpu.decode_step(p_cpu, cache_c, {"tokens": torch.from_numpy(step),
                                                     "pos": torch.from_numpy(pos)}), 1)
        for b, _ in fl:
            lane_taint[b] = True
        if (~lane_taint).any():
            errs.append(max_err(torch, lg.cpu()[~lane_taint], lc[~lane_taint]))
        pos = pos + 1
    if (~lane_taint).any():
        errs.append(max_err(torch, cache_g["v"].cpu()[:, ~lane_taint],
                            cache_c["v"][:, ~lane_taint]))
    routing = ""
    if cfg.moe:
        routing = (f"; routing: smallest top-{k} margin {min_margin:.3g}, tokens whose "
                   f"experts differ card vs CPU {len(flips)} (margins "
                   f"{[f'{m:.3g}' for m in flip_margins]}), positions left out "
                   f"{int(taint.sum())}, lanes left out of decode {int(lane_taint.sum())}")
    print(f"model check {arch} ({layers} layers, head_dim {cfg.resolved_head_dim}, float32, "
          f"prefill {B}x{T} + 4 decode steps): "
          f"max |logits card - CPU| per call {[f'{e:.3g}' for e in errs]}, "
          f"tolerance {LOGIT_ATOL}{routing}")
    check(all(m < NEAR_TIE for m in flip_margins),
          f"model check {arch}: a token routed differently with margin >= {NEAR_TIE}: "
          f"{flip_margins}")
    check(max(errs) <= LOGIT_ATOL,
          f"model check {arch}: card and CPU logits differ by {max(errs)}")


def check_xlstm(torch, dtype: str = "float32") -> None:
    """Phase 4 for xlstm-1.3b: full width cut to one 7:1 group, prefill of
    2 x 300 tokens (the card's kernel runs chunks of 256 + 44, the CPU's
    plain path two chunks of 150) and 4 decode steps.  The card and the CPU,
    both in ``dtype``, are each held against a float64 run of the same
    weights on the CPU.  float32: logits within XLSTM_LOGIT_ATOL and
    XLSTM_VS_CPU x the CPU's distance, and every state leaf; bfloat16 (the
    mLSTM kernel's tensor-core route): logits within XLSTM_VS_CPU x the bf16
    CPU's distance, the state leaves' distances printed.  Both dtypes: the
    first mLSTM layer's state after the prefill, card against the card's
    own prefill with the plain mLSTM in place of the kernel (the layer's
    inputs are then the same bits, so the kernel is held at MLSTM_TOL on
    the model's activations, where deeper layers and the logits would carry
    the model's own rounding noise: ~2 logits at 8 layers in bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mlstm
    from repro_torch.models.api import build_model, tree_map

    def plain_heads(q, k, v, i_pre, f_pre, state=None, *, chunk, out=None):
        h, st = mlstm.mlstm_chunked_heads_plain(q, k, v, i_pre, f_pre, state, chunk=chunk)
        return (h if out is None else out.copy_(h)), st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, T = XLSTM_CHECK
    cfg = dataclasses.replace(get_config("xlstm-1.3b"), num_layers=layers,
                              param_dtype=dtype, dtype=dtype)
    cfg64 = dataclasses.replace(cfg, param_dtype="float64", dtype="float64")
    p_gpu = build_model(cfg, device=DEVICE).init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    sides = {"card": (build_model(cfg, device=DEVICE), p_gpu, DEVICE),
             "card_plain": (build_model(cfg, device=DEVICE), p_gpu, DEVICE),
             "cpu": (build_model(cfg, device="cpu"), p_cpu, "cpu"),
             "cpu64": (build_model(cfg64, device="cpu"), tree_map(torch.Tensor.double, p_cpu),
                       "cpu")}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))) for _ in range(4)]
    logits, caches, first = {}, {}, {}
    xl = cfg.xlstm
    n_mlstm = layers // (xl.mlstm_per_group + xl.slstm_per_group) * xl.mlstm_per_group
    kernel_heads = mlstm.mlstm_chunked_heads
    for name, (model, params, dev) in sides.items():
        before = mlstm.launches
        if name == "card_plain":
            mlstm.mlstm_chunked_heads = plain_heads
        try:
            lg, cache = model.prefill(params, {"tokens": tokens.to(dev)})
        finally:
            mlstm.mlstm_chunked_heads = kernel_heads
        if dev != "cpu":
            want = n_mlstm if name == "card" else 0
            check(mlstm.launches - before == want,
                  f"xlstm {name} prefill launched the mlstm kernel {mlstm.launches - before} "
                  f"times, not {want}")
        # (C, n, m) of the first mLSTM layer, copied before decode updates it
        first[name] = [leaf[0, 0].to("cpu", torch.float64, copy=True)
                       for leaf in cache["mlstm"][:3]]
        logits[name] = [lg.cpu().double()]
        if name == "card_plain":
            continue
        for step in steps:
            lg, _ = model.decode_step(params, cache, {"tokens": step.to(dev), "pos": T})
            logits[name].append(lg.cpu().double())
        caches[name] = tree_map(lambda t: t.cpu().double(), cache)

    def errs(a, b):
        return [(x - y).abs().max().item() for x, y in zip(logits[a], logits[b])]

    e_card, e_cpu, e_pair = errs("card", "cpu64"), errs("cpu", "cpu64"), errs("card", "cpu")
    state = []
    tree_map(lambda a, b: state.append(within(torch, a, b, MLSTM_TOL["state"]["float32"])),
             caches["card"], caches["cpu64"])
    f32 = dtype == "float32"
    layer0 = [within(torch, a, b, MLSTM_TOL["state"][dtype])
              for a, b in zip(first["card"], first["card_plain"])]
    print(f"model check xlstm-1.3b ({layers} layers, {dtype}): first mLSTM layer's state "
          f"after the prefill, kernel vs plain mLSTM on the card, max |diff| (C, n, m) "
          f"{[f'{e:.3g}' for e, _ in layer0]}, within {MLSTM_TOL['state'][dtype]}: "
          f"{all(ok for _, ok in layer0)}; prefill logits kernel vs plain mLSTM "
          f"{errs('card', 'card_plain')[0]:.3g}")
    print(f"model check xlstm-1.3b ({layers} layers, {dtype}, prefill {B}x{T} + 4 decode "
          f"steps), max |logits - float64 CPU| per call: card {[f'{e:.3g}' for e in e_card]}, "
          f"{dtype} CPU {[f'{e:.3g}' for e in e_cpu]}; card vs {dtype} CPU "
          f"{[f'{e:.3g}' for e in e_pair]}; tolerance "
          f"{str(XLSTM_LOGIT_ATOL) + ' and ' if f32 else ''}{XLSTM_VS_CPU}x the {dtype} CPU's; "
          f"state leaves max |card - float64| {[f'{e:.3g}' for e, _ in state]}"
          + (f", within {MLSTM_TOL['state']['float32']}: {all(ok for _, ok in state)}"
             if f32 else ""))
    check(max(e_card) <= XLSTM_VS_CPU * max(e_cpu) and (not f32 or max(e_card) <= XLSTM_LOGIT_ATOL),
          f"model check xlstm-1.3b {dtype}: card logits {max(e_card)} from float64")
    check(not f32 or all(ok for _, ok in state), "model check xlstm-1.3b: states differ")
    check(all(ok for _, ok in layer0),
          f"model check xlstm-1.3b {dtype}: the first mLSTM layer's state differs from the "
          f"plain mLSTM's on the card: {[e for e, _ in layer0]}")


def check_zamba2(torch) -> None:
    """Phase 4 for zamba2-2.7b: full width cut to 2 groups (12 Mamba2
    blocks, 2 applications of the shared block), float32, prefill of 2 x
    300 tokens (the card's SSD kernel runs chunks of 256 + 44, the CPU's
    plain path two chunks of 150) and 4 per-slot decode steps.  Logits and
    every cache leaf, card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, T = ZAMBA2_CHECK
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=layers,
                              param_dtype="float32", dtype="float32")
    apps = layers // cfg.ssm.attn_every
    gpu, cpu = build_model(cfg, device=DEVICE), build_model(cfg, device="cpu")
    p_gpu = gpu.init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    max_len = T + 8
    before = (ssd.launches, fla.launches)
    lg, cg = gpu.prefill(p_gpu, {"tokens": tokens.to(DEVICE)})
    check((ssd.launches - before[0], fla.launches - before[1]) == (layers, apps),
          f"zamba2 prefill launched ssd {ssd.launches - before[0]}, flash "
          f"{fla.launches - before[1]} times")
    lc, cc = cpu.prefill(p_cpu, {"tokens": tokens})
    errs = [max_err(torch, lg.cpu(), lc)]
    state = {}

    def leaf_errs(card, cpu_tree):
        for name, a, b in (("h", card["mamba"][0], cpu_tree["mamba"][0]),
                           ("conv", card["mamba"][1], cpu_tree["mamba"][1]),
                           ("k", card["attn_kv"]["k"], cpu_tree["attn_kv"]["k"]),
                           ("v", card["attn_kv"]["v"], cpu_tree["attn_kv"]["v"])):
            tol = SSD_TOL["state"]["float32"] if name == "h" else (LOGIT_ATOL, 0.0)
            err, ok = within(torch, a.cpu(), b, tol)
            prev = state.get(name, (0.0, True))
            state[name] = (max(prev[0], err), prev[1] and ok)

    leaf_errs(cg, cc)
    cache_g, cache_c = gpu.init_cache(B, max_len), cpu.init_cache(B, max_len)
    for full, part in ((cache_g, cg), (cache_c, cc)):
        for i in range(2):
            full["mamba"][i].copy_(part["mamba"][i])
        for name in ("k", "v"):
            full["attn_kv"][name][:, :, :T] = part["attn_kv"][name]
    pos = np.array([T, T - 50])   # lane 1 decodes as if its prompt were shorter
    for _ in range(4):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        before = dec.launches
        lg, _ = gpu.decode_step(p_gpu, cache_g, {"tokens": torch.from_numpy(step).to(DEVICE),
                                                 "pos": torch.from_numpy(pos).to(DEVICE)})
        check(dec.launches - before == apps,
              f"zamba2 decode launched decode_attention {dec.launches - before} times")
        lc, _ = cpu.decode_step(p_cpu, cache_c, {"tokens": torch.from_numpy(step),
                                                 "pos": torch.from_numpy(pos)})
        errs.append(max_err(torch, lg.cpu(), lc))
        pos = pos + 1
    leaf_errs(cache_g, cache_c)
    print(f"model check zamba2-2.7b ({layers} Mamba2 blocks, {apps} shared-block applications, "
          f"float32, prefill {B}x{T} + 4 decode steps): max |logits card - CPU| per call "
          f"{[f'{e:.3g}' for e in errs]}, tolerance {LOGIT_ATOL}; cache leaves max "
          f"|card - CPU| {({k: f'{e:.3g}' for k, (e, _) in state.items()})}, h within "
          f"{SSD_TOL['state']['float32']}, conv/k/v within {LOGIT_ATOL}: "
          f"{all(ok for _, ok in state.values())}")
    check(max(errs) <= LOGIT_ATOL, f"model check zamba2-2.7b: card and CPU logits differ by "
                                   f"{max(errs)}")
    check(all(ok for _, ok in state.values()), f"model check zamba2-2.7b: caches differ {state}")


def check_zamba2_bf16(torch) -> None:
    """Phase 4 for zamba2-2.7b in bfloat16, the SSD kernel's tensor-core
    route that phase 5 serves: full width cut to 2 groups, prefill of 2 x
    300 tokens (the card's kernel runs chunks of 256 + 44, the CPU's plain
    path two chunks of 150) and 4 decode steps, on the card and in bfloat16
    on the CPU, each held against a float64 run of the same weights on the
    CPU: the card's logits within XLSTM_VS_CPU x the bf16 CPU's distance
    (bf16 logits carry the model's own rounding noise, as xLSTM's do).  The
    first Mamba2 layer's h after the prefill, card against the card's own
    prefill with the plain SSD in place of the kernel (the layer's inputs
    are then the same bits), within SSD_TOL["state"]["bfloat16"]."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    layers, B, T = ZAMBA2_CHECK
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), num_layers=layers,
                              param_dtype="bfloat16", dtype="bfloat16")
    cfg64 = dataclasses.replace(cfg, param_dtype="float64", dtype="float64")
    p_gpu = build_model(cfg, device=DEVICE).init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    sides = {"card": (cfg, p_gpu, DEVICE), "card_plain": (cfg, p_gpu, DEVICE),
             "cpu": (cfg, p_cpu, "cpu"),
             "cpu64": (cfg64, tree_map(torch.Tensor.double, p_cpu), "cpu")}
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    steps = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1))) for _ in range(4)]
    logits, first = {}, {}
    kernel = ssd.ssd_chunked
    for name, (c, params, dev) in sides.items():
        model = build_model(c, device=dev)
        before = ssd.launches
        if name == "card_plain":
            ssd.ssd_chunked = ssd.ssd_chunked_plain
        try:
            lg, part = model.prefill(params, {"tokens": tokens.to(dev)})
        finally:
            ssd.ssd_chunked = kernel
        if dev != "cpu":
            want = layers if name == "card" else 0
            check(ssd.launches - before == want,
                  f"zamba2 bf16 {name} prefill launched the ssd kernel "
                  f"{ssd.launches - before} times, not {want}")
        first[name] = part["mamba"][0][0, 0].to("cpu", torch.float64, copy=True)
        logits[name] = [lg.cpu().double()]
        if name == "card_plain":
            continue
        cache = model.init_cache(B, T + len(steps))
        for i in range(2):
            cache["mamba"][i].copy_(part["mamba"][i])
        for n in ("k", "v"):
            cache["attn_kv"][n][:, :, :T] = part["attn_kv"][n]
        for i, step in enumerate(steps):
            lg, _ = model.decode_step(params, cache, {"tokens": step.to(dev), "pos": T + i})
            logits[name].append(lg.cpu().double())

    def errs(a, b):
        return [(x - y).abs().max().item() for x, y in zip(logits[a], logits[b])]

    e_card, e_cpu, e_pair = errs("card", "cpu64"), errs("cpu", "cpu64"), errs("card", "cpu")
    tol = SSD_TOL["state"]["bfloat16"]
    err_h, ok_h = within(torch, first["card"], first["card_plain"], tol)
    used = ((first["card"] - first["card_plain"]).abs()
            / (tol[0] + tol[1] * first["card_plain"].abs())).max().item()
    print(f"model check zamba2-2.7b ({layers} Mamba2 blocks, bfloat16): first Mamba2 layer's h "
          f"after the prefill, kernel vs plain SSD on the card, max |diff| {err_h:.3g}, within "
          f"{tol}: {ok_h} (largest share of its tolerance {used:.3g}); prefill logits kernel "
          f"vs plain SSD {errs('card', 'card_plain')[0]:.3g}")
    print(f"model check zamba2-2.7b ({layers} Mamba2 blocks, bfloat16, prefill {B}x{T} + "
          f"{len(steps)} decode steps), max |logits - float64 CPU| per call: card "
          f"{[f'{e:.3g}' for e in e_card]}, bfloat16 CPU {[f'{e:.3g}' for e in e_cpu]}; card vs "
          f"bfloat16 CPU {[f'{e:.3g}' for e in e_pair]}; tolerance {XLSTM_VS_CPU}x the "
          f"bfloat16 CPU's")
    check(max(e_card) <= XLSTM_VS_CPU * max(e_cpu),
          f"model check zamba2-2.7b bfloat16: card logits {max(e_card)} from float64")
    check(ok_h, f"model check zamba2-2.7b bfloat16: the first Mamba2 layer's h differs from the "
                f"plain SSD's on the card by {err_h}")


def check_depth(torch, arch: str) -> None:
    """Phase 4 at the published depth: xlstm-1.3b (48 layers) or
    zamba2-2.7b (54 Mamba2 blocks, 9 shared-block applications) at full
    width in float32, a prefill of DEPTH_CHECK's B x T tokens and its greedy
    decode steps, on the card, on the CPU in float32 and on the CPU in
    float64.  The float64 run picks each next token (greedy, per sequence)
    and the other two decode the same tokens, so every call's logits
    compare.  The card's logits within XLSTM_LOGIT_ATOL of float64 and
    within XLSTM_VS_CPU x the float32 CPU's own distance (float32 error
    grows with depth); the card's greedy token the float64 run's at every
    call where the float64 top-2 margin exceeds XLSTM_LOGIT_ATOL, a token
    that differs at a smaller margin reported as a near-tie; exact kernel
    launches on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, T, steps = DEPTH_CHECK
    cfg = dataclasses.replace(get_config(arch), param_dtype="float32", dtype="float32")
    cfg64 = dataclasses.replace(cfg, param_dtype="float64", dtype="float64")
    hybrid = cfg.family == "hybrid"
    p_gpu = build_model(cfg, device=DEVICE).init(seed=0)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    rng = np.random.default_rng(0)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    logits, tokens, launches = {}, [], {}
    for name, c, params, dev in (("cpu64", cfg64, tree_map(torch.Tensor.double, p_cpu), "cpu"),
                                 ("card", cfg, p_gpu, DEVICE), ("cpu", cfg, p_cpu, "cpu")):
        model = build_model(c, device=dev)
        zero_counts()
        lg, cache = model.prefill(params, {"tokens": prompt.to(dev)})
        if hybrid:   # the prefill's cache holds T positions of attention K/V
            part, cache = cache, model.init_cache(B, T + steps)
            for i in range(2):
                cache["mamba"][i].copy_(part["mamba"][i])
            for n in ("k", "v"):
                cache["attn_kv"][n][:, :, :T] = part["attn_kv"][n]
            del part
        out = [lg.cpu().double()]
        for i in range(steps):
            if name == "cpu64":
                tokens.append(out[-1][:, -1].argmax(-1))
            lg, _ = model.decode_step(params, cache, {"tokens": tokens[i].reshape(B, 1).to(dev),
                                                      "pos": T + i})
            out.append(lg.cpu().double())
        if name == "card":
            torch.cuda.synchronize()
            launches = read_counts()
        logits[name] = out
        del model, cache, params, lg
    del p_gpu
    release(torch)

    def errs(a):
        return [(x - y).abs().max().item() for x, y in zip(logits[a], logits["cpu64"])]

    e_card, e_cpu = errs("card"), errs("cpu")
    # greedy tokens at every call's last position, against the float64 run's
    near, differ_cpu = [], 0
    for i, ref in enumerate(logits["cpu64"]):
        top2 = ref[:, -1].topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        want = ref[:, -1].argmax(-1)
        differ_cpu += int((logits["cpu"][i][:, -1].argmax(-1) != want).sum())
        for b in (logits["card"][i][:, -1].argmax(-1) != want).nonzero().flatten().tolist():
            near.append((i, b, margin[b].item()))
    expected = serve_launches(cfg, steps, 1)
    layers = (f"{cfg.num_layers} Mamba2 blocks, {cfg.num_layers // cfg.ssm.attn_every} "
              f"shared-block applications" if hybrid else f"{cfg.num_layers} layers")
    print(f"model check {arch} at published depth ({layers}, float32, prefill {B}x{T} + "
          f"{steps} greedy steps on the float64 run's tokens), max |logits - float64 CPU| per "
          f"call: card {[f'{e:.3g}' for e in e_card]}, float32 CPU "
          f"{[f'{e:.3g}' for e in e_cpu]}; tolerance {XLSTM_LOGIT_ATOL} and {XLSTM_VS_CPU}x the "
          f"float32 CPU's; greedy tokens differing from float64: card {len(near)} (call, "
          f"sequence, float64 top-2 margin {[(i, b, f'{m:.3g}') for i, b, m in near]}), "
          f"float32 CPU {differ_cpu}; launches {launches}")
    check(launches == expected, f"model check {arch} at depth: launches {launches} != {expected}")
    check(max(e_card) <= XLSTM_LOGIT_ATOL and max(e_card) <= XLSTM_VS_CPU * max(e_cpu),
          f"model check {arch} at depth: card logits {max(e_card)} from float64 (float32 CPU "
          f"{max(e_cpu)})")
    check(all(m <= XLSTM_LOGIT_ATOL for _, _, m in near),
          f"model check {arch} at depth: a greedy token differs from float64's where its top-2 "
          f"margin exceeds {XLSTM_LOGIT_ATOL}: {near}")


def card_and_cpu(torch, cfg):
    """The card's and the CPU's model of ``cfg`` on the same seeded params
    (drawn on the card, copied to the host), full float32 products on both
    sides."""
    from repro_torch.models.api import build_model, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu, cpu = build_model(cfg, device=DEVICE), build_model(cfg, device="cpu")
    p_gpu = gpu.init(seed=0)
    return gpu, p_gpu, cpu, tree_map(lambda t: t.cpu(), p_gpu)


def tree_errs(torch, card, cpu_tree) -> dict:
    """max |card - CPU| of every leaf of two cache trees, by leaf path."""
    out = {}

    def walk(a, b, path):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, (tuple, list)):
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            out[path] = max_err(torch, a.cpu(), b)

    walk(card, cpu_tree, "")
    return out


def check_zamba2_window(torch) -> None:
    """Phase 4 for zamba2-2.7b's windowed shared block: full width cut to 2
    groups, float32, window 256 over a 1024-token prompt (forward logits
    and caches, the windowed flash kernel on the card), then the ring built
    from the prompt's last 256 positions (slot p % 256 holds position p)
    and 8 per-slot decode steps that wrap it, card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla

    layers, B, T, W = ZAMBA2_CHECK[0], 2, 1024, 256
    base = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(base, num_layers=layers, param_dtype="float32", dtype="float32",
                              ssm=dataclasses.replace(base.ssm, attn_window=W))
    apps = layers // cfg.ssm.attn_every
    gpu, p_gpu, cpu, p_cpu = card_and_cpu(torch, cfg)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T)))
    before = fla.launches_window
    lg, cg = gpu.prefill(p_gpu, {"tokens": tokens.to(DEVICE)})
    check(fla.launches_window - before == apps,
          f"windowed zamba2 prefill launched windowed flash {fla.launches_window - before} times")
    lc, cc = cpu.prefill(p_cpu, {"tokens": tokens})
    errs = [max_err(torch, lg.cpu(), lc)]
    leaves = {}

    def leaf_errs(card, cpu_tree, tag):
        # h within the SSD state tolerance, conv and k/v within LOGIT_ATOL
        for name, a, b in (("h", card["mamba"][0], cpu_tree["mamba"][0]),
                           ("conv", card["mamba"][1], cpu_tree["mamba"][1]),
                           ("k", card["attn_kv"]["k"], cpu_tree["attn_kv"]["k"]),
                           ("v", card["attn_kv"]["v"], cpu_tree["attn_kv"]["v"])):
            tol = SSD_TOL["state"]["float32"] if name == "h" else (LOGIT_ATOL, 0.0)
            leaves[f"{tag} {name}"] = within(torch, a.cpu(), b, tol)

    leaf_errs(cg, cc, "prefill")
    caches = []
    for model, part in ((gpu, cg), (cpu, cc)):
        cache = model.init_cache(B, 2 * T)
        check(cache["attn_kv"]["k"].shape[2] == W, "the ring is not window-sized")
        for i in range(2):
            cache["mamba"][i].copy_(part["mamba"][i])
        for n in ("k", "v"):   # positions T - W .. T - 1 sit in slots 0 .. W - 1
            cache["attn_kv"][n].copy_(part["attn_kv"][n][:, :, T - W:])
        caches.append(cache)
    pos = np.array([T, T])
    for _ in range(8):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        before = dec.launches
        lg, _ = gpu.decode_step(p_gpu, caches[0], {"tokens": torch.from_numpy(step).to(DEVICE),
                                                   "pos": torch.from_numpy(pos).to(DEVICE)})
        check(dec.launches - before == apps,
              f"windowed zamba2 decode launched decode_attention {dec.launches - before} times")
        lc, _ = cpu.decode_step(p_cpu, caches[1], {"tokens": torch.from_numpy(step),
                                                   "pos": torch.from_numpy(pos)})
        errs.append(max_err(torch, lg.cpu(), lc))
        pos = pos + 1
    leaf_errs(caches[0], caches[1], "decode")
    print(f"model check zamba2-2.7b windowed ({layers} Mamba2 blocks, window {W}, float32, "
          f"prefill {B}x{T}, 8 decode steps across the ring's wrap): max |logits card - CPU| "
          f"per call {[f'{e:.3g}' for e in errs]}, tolerance {LOGIT_ATOL}; cache leaves max "
          f"|card - CPU| {({k: f'{e:.3g}' for k, (e, _) in leaves.items()})}, h within "
          f"{SSD_TOL['state']['float32']}, conv/k/v within {LOGIT_ATOL}: "
          f"{all(ok for _, ok in leaves.values())}")
    check(max(errs) <= LOGIT_ATOL, f"windowed zamba2: card and CPU logits differ by {max(errs)}")
    check(all(ok for _, ok in leaves.values()), f"windowed zamba2: caches differ {leaves}")


def check_whisper(torch) -> None:
    """Phase 4 for whisper-large-v3: full width at 2 encoder + 2 decoder
    layers, float32, 2 sequences over 1500 stub frames (numpy seed 0) and a
    4-token prompt: prefill logits and both caches, then 8 decode steps
    (the cross cache read as a static cache), card against CPU."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fla

    base = get_config("whisper-large-v3")
    cfg = dataclasses.replace(base, num_layers=2, param_dtype="float32", dtype="float32",
                              encdec=dataclasses.replace(base.encdec, encoder_layers=2))
    gpu, p_gpu, cpu, p_cpu = card_and_cpu(torch, cfg)
    rng = np.random.default_rng(0)
    B, T, F = 2, 4, cfg.encdec.encoder_frames
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))),
             "frames": torch.from_numpy(rng.standard_normal((B, F, cfg.d_model), np.float32))}
    before = fla.launches
    lg, cg = gpu.prefill(p_gpu, {k: v.to(DEVICE) for k, v in batch.items()})
    check(fla.launches - before == 3 * 2, f"whisper prefill launched flash "
                                          f"{fla.launches - before} times, not 6")
    lc, cc = cpu.prefill(p_cpu, batch)
    errs = [max_err(torch, lg.cpu(), lc)]
    leaves = tree_errs(torch, cg, cc)
    caches = []
    for model, part in ((gpu, cg), (cpu, cc)):
        cache = model.init_cache(B, T + 8)
        for n in ("k", "v"):
            cache["self"][n][:, :, :T] = part["self"][n]
        cache["cross"] = part["cross"]
        caches.append(cache)
    pos = np.array([T, T - 1])
    for _ in range(8):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        before = dec.launches
        lg, _ = gpu.decode_step(p_gpu, caches[0], {"tokens": torch.from_numpy(step).to(DEVICE),
                                                   "pos": torch.from_numpy(pos).to(DEVICE)})
        check(dec.launches - before == 2 * 2, f"whisper decode launched decode_attention "
                                              f"{dec.launches - before} times, not 4")
        lc, _ = cpu.decode_step(p_cpu, caches[1], {"tokens": torch.from_numpy(step),
                                                   "pos": torch.from_numpy(pos)})
        errs.append(max_err(torch, lg.cpu(), lc))
        pos = pos + 1
    leaves.update({f"decode{k}": e for k, e in tree_errs(torch, caches[0], caches[1]).items()})
    print(f"model check whisper-large-v3 (2 + 2 layers, float32, {B} x {F} frames, prefill "
          f"{B}x{T} + 8 decode steps): max |logits card - CPU| per call "
          f"{[f'{e:.3g}' for e in errs]}, tolerance {LOGIT_ATOL}; cache leaves "
          f"{({k: f'{e:.3g}' for k, e in leaves.items()})}")
    check(max(errs) <= LOGIT_ATOL, f"whisper: card and CPU logits differ by {max(errs)}")
    check(max(leaves.values()) <= LOGIT_ATOL, f"whisper: caches differ {leaves}")


def check_vlm(torch) -> None:
    """Phase 4 for internvl2-76b: full width at VLM_CHECK_LAYERS layers (the
    depth a float32 copy on each side allows), 2 sequences of 256 patch
    embeddings (numpy seed 0) and 8 text tokens: prefill logits and caches,
    then 4 per-slot decode steps after the prefix, card against CPU."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("internvl2-76b"), num_layers=VLM_CHECK_LAYERS,
                              param_dtype="float32", dtype="float32")
    gpu, p_gpu, cpu, p_cpu = card_and_cpu(torch, cfg)
    rng = np.random.default_rng(0)
    B, T, P = 2, 8, cfg.vlm.num_patches
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))),
             "patch_embeds": torch.from_numpy(rng.standard_normal((B, P, cfg.d_model),
                                                                  np.float32))}
    lg, cg = gpu.prefill(p_gpu, {k: v.to(DEVICE) for k, v in batch.items()})
    lc, cc = cpu.prefill(p_cpu, batch)
    check(lg.shape == (B, P + T, cfg.vocab_size), f"internvl2 prefill logits {lg.shape}")
    errs = [max_err(torch, lg.cpu(), lc)]
    leaves = tree_errs(torch, cg, cc)
    caches = []
    for model, part in ((gpu, cg), (cpu, cc)):
        cache = model.init_cache(B, P + T + 4)
        for n in ("k", "v"):
            cache[n][:, :, :P + T] = part[n]
        caches.append(cache)
    pos = np.array([P + T, P + T - 3])
    for _ in range(4):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        lg, _ = gpu.decode_step(p_gpu, caches[0], {"tokens": torch.from_numpy(step).to(DEVICE),
                                                   "pos": torch.from_numpy(pos).to(DEVICE)})
        lc, _ = cpu.decode_step(p_cpu, caches[1], {"tokens": torch.from_numpy(step),
                                                   "pos": torch.from_numpy(pos)})
        errs.append(max_err(torch, lg.cpu(), lc))
        pos = pos + 1
    leaves.update({f"decode{k}": e for k, e in tree_errs(torch, caches[0], caches[1]).items()})
    print(f"model check internvl2-76b ({cfg.num_layers} layers, float32, prefill {B} x ({P} "
          f"patches + {T} tokens) + 4 decode steps): max |logits card - CPU| per call "
          f"{[f'{e:.3g}' for e in errs]}, tolerance {LOGIT_ATOL}; cache leaves "
          f"{({k: f'{e:.3g}' for k, e in leaves.items()})}")
    check(max(errs) <= LOGIT_ATOL, f"internvl2: card and CPU logits differ by {max(errs)}")
    check(max(leaves.values()) <= LOGIT_ATOL, f"internvl2: caches differ {leaves}")


def check_kv_quant(torch) -> None:
    """Phase 4 for the int8 cache: internlm2-20b with ``kv_quant`` at full
    width cut to 2 layers, float32, 2 sequences decoded step by step from
    position 0 for 12 steps (as ``tests/test_models.py:124-144`` drives the
    reference), card against CPU: logits, the float32 scales, and the int8
    values (a value may round to its neighbour where the two sides'
    projections straddle a rounding edge; such values are counted)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dec

    cfg = dataclasses.replace(get_config("internlm2-20b"), num_layers=2, kv_quant=True,
                              param_dtype="float32", dtype="float32")
    gpu, p_gpu, cpu, p_cpu = card_and_cpu(torch, cfg)
    rng = np.random.default_rng(0)
    B, steps = 2, 12
    caches = [gpu.init_cache(B, 16), cpu.init_cache(B, 16)]
    errs = []
    for t in range(steps):
        step = rng.integers(0, cfg.vocab_size, (B, 1))
        before = dec.launches_q8
        lg, _ = gpu.decode_step(p_gpu, caches[0], {"tokens": torch.from_numpy(step).to(DEVICE),
                                                   "pos": torch.tensor(t, device=DEVICE)})
        check(dec.launches_q8 - before == 2, f"kv_quant decode launched the int8 kernel "
                                             f"{dec.launches_q8 - before} times, not 2")
        lc, _ = cpu.decode_step(p_cpu, caches[1], {"tokens": torch.from_numpy(step),
                                                   "pos": torch.tensor(t)})
        errs.append(max_err(torch, lg.cpu(), lc))
    card = {n: c.cpu() for n, c in caches[0].items()}
    int8_diff = {n: int((card[n].int() - caches[1][n].int()).abs().max()) for n in ("k", "v")}
    int8_moved = sum(int((card[n] != caches[1][n]).sum()) for n in ("k", "v"))
    scale_rel = max(((card[n] - caches[1][n]).abs() / caches[1][n].abs().clamp(min=1e-30))
                    .max().item() for n in ("k_scale", "v_scale"))
    print(f"model check internlm2-20b kv_quant (2 layers, float32, {B} sequences x {steps} "
          f"steps from position 0): max |logits card - CPU| per call "
          f"{[f'{e:.3g}' for e in errs]}, tolerance {LOGIT_ATOL}; int8 K/V max |diff| "
          f"{int8_diff} ({int8_moved} of {2 * card['k'].numel()} values moved), scales max "
          f"relative diff {scale_rel:.3g}")
    check(max(errs) <= LOGIT_ATOL, f"kv_quant: card and CPU logits differ by {max(errs)}")
    check(max(int8_diff.values()) <= 1 and scale_rel <= 1e-5,
          f"kv_quant: caches differ: int8 {int8_diff}, scales {scale_rel}")


# -- phase 5: serve the full configs -----------------------------------------


def timed_engine(eng):
    """Wrap ``eng.admit``/``eng.step`` to record TTFT (each admission ends on
    its first token's host transfer) and the wall time of each step that
    emitted tokens, with how many."""
    ttft, step_s = [], []
    admit, step = eng.admit, eng.step

    def timed_admit(req, slot):
        t = time.perf_counter()
        admit(req, slot)
        ttft.append(time.perf_counter() - t)

    def timed_step(key=None):
        t = time.perf_counter()
        out = step(key)
        if out:
            step_s.append((time.perf_counter() - t, len(out)))
        return out

    eng.admit, eng.step = timed_admit, timed_step
    return ttft, step_s


def serve_launches(cfg, steps: int, admissions: int) -> dict:
    """The kernel launches of a ``ServingEngine`` of ``cfg`` over ``steps``
    decode steps and ``admissions`` prefills, by KERNELS name: no variant,
    no backward."""
    xlstm = cfg.family == "ssm"
    hybrid = cfg.family == "hybrid"
    # attention layers (zamba2: applications of the shared block)
    L_attn = (0 if xlstm else cfg.num_layers // cfg.ssm.attn_every if hybrid
              else cfg.num_layers)
    per = (cfg.xlstm.mlstm_per_group + cfg.xlstm.slstm_per_group) if xlstm else 1
    L_mlstm = cfg.num_layers // per * cfg.xlstm.mlstm_per_group if xlstm else 0
    L_ssd = cfg.num_layers if hybrid else 0
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(decode_attention=L_attn * steps, flash_attention=L_attn * admissions,
                    grouped_matmul=3 * L_attn * (steps + admissions) if cfg.moe else 0,
                    mlstm=L_mlstm * admissions, mamba2_ssd=L_ssd * admissions)
    return expected


def serve(torch, arch: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServingEngine

    cfg = dataclasses.replace(get_config(arch), param_dtype="bfloat16")
    xlstm = cfg.family == "ssm"
    hybrid = cfg.family == "hybrid"
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    eng = ServingEngine(model, params, num_slots=8, max_len=2048)
    cache_bytes = sum(t.numel() * t.element_size() for t in _leaves(eng.payload["cache"]))
    ttft, step_s = timed_engine(eng)
    rng = np.random.default_rng(0)
    longest = SERVE_PROMPT_MAX.get(arch, 1024)
    lengths = rng.integers(64, longest + 1, 16)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=64)
            for n in lengths]

    # this model's run starts here
    zero_counts()
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(sorted(out) == list(range(16)), f"run() served {sorted(out)}")
    check(all(len(out[i]) == 64 for i in range(16)), "a request got the wrong token count")
    check(all(0 <= t < cfg.vocab_size for ts in out.values() for t in ts), "token out of vocab")
    n_tokens = sum(len(ts) for ts in out.values())

    # a profiled window of decode steps with all 8 slots busy, then one
    # step_many(16) block against 16 step() calls from the same state
    block = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=m, rid=100 + i)
             for i, (n, m) in enumerate(zip(rng.integers(64, longest + 1, 8),
                                            [40] * 6 + [14, 9]))]
    for slot, r in enumerate(block):
        eng.admit(r, slot)
    profile = profile_window(torch, eng.step, 4)
    L_attn = serve_launches(cfg, 1, 0)["decode_attention"]
    graphed = graphed_blocks(torch, eng, block, arch, L_attn)
    while any(r is not None for r in eng.slot_req):
        eng.step()

    # a profiled window of admissions of one 1024-token prompt (the largest
    # of the run), each evicted again: where TTFT goes.  Three, or one for
    # xLSTM, whose sLSTM prefill loop makes ~150 k launches per admission
    long_prompt = rng.integers(0, cfg.vocab_size, 1024)
    n_long = 1 if xlstm else 3

    def admit_long():
        eng.admit(Request(prompt=long_prompt, max_new_tokens=2, rid=300), 0)
        eng.evict(300)

    admit_profile = profile_window(torch, admit_long, n_long)

    sampled = eng.run([Request(prompt=rng.integers(0, cfg.vocab_size, 100),
                               max_new_tokens=8, temperature=0.8, rid=200)])[200]
    check(len(sampled) == 8 and all(0 <= t < cfg.vocab_size for t in sampled),
          f"sampled request: {sampled}")
    torch.cuda.synchronize()
    launches = read_counts()
    admissions = 16 + len(block) + n_long + 1
    steps = eng.steps_dispatched
    expected = serve_launches(cfg, steps, admissions)
    check(launches == expected,
          f"{arch} launches {launches} != {expected} ({cfg.num_layers} layers, {steps} steps, "
          f"{admissions} admissions)")

    full = [t for t, n in step_s if n == 8]
    stats = {
        "model": cfg.name, "layers": cfg.num_layers, "params": n_params,
        "param_bytes": n_bytes, "cache_bytes": cache_bytes,
        "dtype": "bfloat16", "num_slots": 8, "max_len": 2048,
        "init_s": init_s,
        "run_wall_s": wall, "run_tokens": n_tokens, "tokens_per_s": n_tokens / wall,
        "ttft_ms_p50": 1e3 * float(np.median(ttft[:16])),
        "ttft_ms_max": 1e3 * float(np.max(ttft[:16])),
        "ttft_n": 16,
        "prompt_tokens": int(lengths.sum()),
        "decode_step_ms_p50_8_active": 1e3 * float(np.median(full)),
        "decode_step_ms_p90_8_active": 1e3 * float(np.percentile(full, 90)),
        "decode_step_n_8_active": len(full),
        "steps_dispatched": steps, "admissions": admissions,
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_decode_step": profile,
        "profile_admission_1024": admit_profile,
        "graphed_block": graphed,
    }
    print(f"served {cfg.name}: {n_params / 1e9:.2f} B params, {stats}")
    return stats


# -- phase 5b: the remaining attention paths at full config (bf16) ----------

# zamba2-2.7b served with the long-context cell's window
# (repro/launch/plans.py:61): 8 slots, 8 requests of 256 new tokens; every
# prompt is long enough that its decode wraps the 4096-slot ring
WINDOWED = {"window": 4096, "slots": 8, "requests": 8, "new_tokens": 256,
            "prompt": (3900, 4000), "max_len": 4352}


def serve_windowed(torch) -> dict:
    """zamba2-2.7b at its full config in bf16 with attn_window 4096, served
    through ServingEngine past the ring's wrap: exact launches (flash, all
    windowed, 9 and SSD 54 per admission, decode 9 per step) and
    ``step_many(16)`` equal to 16 ``step()`` calls, with lanes across the
    wrap."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import Request, ServingEngine

    W, n_req, new = WINDOWED["window"], WINDOWED["requests"], WINDOWED["new_tokens"]
    base = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(base, param_dtype="bfloat16",
                              ssm=dataclasses.replace(base.ssm, attn_window=W))
    model = build_model(cfg)
    params = model.init(seed=0)
    eng = ServingEngine(model, params, num_slots=WINDOWED["slots"], max_len=WINDOWED["max_len"])
    check(eng.payload["cache"]["attn_kv"]["k"].shape[2] == W, "the ring is not window-sized")
    ttft, step_s = timed_engine(eng)
    rng = np.random.default_rng(0)
    lo, hi = WINDOWED["prompt"]
    lengths = rng.integers(lo, hi + 1, n_req)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=new)
            for n in lengths]
    # the last position a request writes is prompt + new - 2
    wrapped = int((lengths + new - 2 >= W).sum())

    zero_counts()
    t0 = time.perf_counter()
    out = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    steps = eng.steps_dispatched
    check(sorted(out) == list(range(n_req)) and all(len(out[i]) == new for i in range(n_req)),
          "windowed zamba2: run() served the wrong requests or token counts")
    check(all(0 <= t < cfg.vocab_size for ts in out.values() for t in ts), "token out of vocab")
    apps, L = cfg.num_layers // cfg.ssm.attn_every, cfg.num_layers
    expected = dict.fromkeys(launches, 0)
    expected.update(decode_attention=apps * steps, flash_attention=apps * n_req,
                    flash_attention_window=apps * n_req, mamba2_ssd=L * n_req)
    check(launches == expected, f"windowed zamba2 launches {launches} != {expected}")

    # step_many(16) against 16 step() calls from one state, with every lane
    # crossing the wrap inside the block
    block = [Request(prompt=rng.integers(0, cfg.vocab_size, n), max_new_tokens=24, rid=100 + i)
             for i, n in enumerate(rng.integers(W - 10, W - 2, WINDOWED["slots"]))]
    for slot, r in enumerate(block):
        eng.admit(r, slot)
    profile = profile_window(torch, eng.step, 4)
    graphed = graphed_blocks(torch, eng, block, "windowed zamba2", apps)
    while any(r is not None for r in eng.slot_req):
        eng.step()
    full = [t for t, n in step_s if n == WINDOWED["slots"]]
    n_tokens = sum(len(ts) for ts in out.values())
    stats = {
        "model": f"{cfg.name} attn_window {W}", "layers": cfg.num_layers, "dtype": "bfloat16",
        "num_slots": WINDOWED["slots"], "max_len": WINDOWED["max_len"], "ring": W,
        "prompt_tokens": int(lengths.sum()), "prompts": [int(n) for n in lengths],
        "requests_wrapped": wrapped, "run_wall_s": wall, "run_tokens": n_tokens,
        "tokens_per_s": n_tokens / wall,
        "ttft_ms_p50": 1e3 * float(np.median(ttft[:n_req])),
        "ttft_ms_max": 1e3 * float(np.max(ttft[:n_req])),
        "decode_step_ms_p50_8_active": 1e3 * float(np.median(full)),
        "decode_step_ms_p90_8_active": 1e3 * float(np.percentile(full, 90)),
        "decode_step_n_8_active": len(full), "steps_dispatched": steps, "admissions": n_req,
        "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "profile_decode_step": profile, "graphed_block": graphed,
    }
    print(f"served {stats['model']} past the ring's wrap ({wrapped} of {n_req} requests "
          f"wrapped): {stats}")
    return stats


def decode_kv_quant(torch, steps: int = 64) -> dict:
    """internlm2-20b at its full config (48 layers, bf16 weights): 8
    sequences decoded step by step from position 0 on the same token
    stream, once over the bf16 cache and once over the int8 cache; logits
    within the reference test's bound (max |int8 - bf16| / max |bf16| <
    0.05), step times side by side, 48 int8 decode launches a step."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("internlm2-20b"), param_dtype="bfloat16")
    models = {"bf16": build_model(cfg), "int8": build_model(dataclasses.replace(cfg,
                                                                                kv_quant=True))}
    params = models["bf16"].init(seed=0)
    B, max_len = 8, 2048
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size,
                                                                (B, steps))).to(DEVICE)
    logits, step_ms, launches = {}, {}, {}
    for name, model in models.items():
        cache = model.init_cache(B, max_len)
        zero_counts()
        out, times = [], []
        for t in range(steps):
            t0 = time.perf_counter()
            lg, _ = model.decode_step(params, cache, {"tokens": tokens[:, t:t + 1],
                                                      "pos": torch.tensor(t, device=DEVICE)})
            out.append(lg[:, 0].float())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        launches[name] = read_counts()
        logits[name] = torch.stack(out)
        step_ms[name] = 1e3 * float(np.median(times))
        del cache
    L = cfg.num_layers
    for name, want_q8 in (("bf16", 0), ("int8", L * steps)):
        expected = dict.fromkeys(launches[name], 0)
        expected.update(decode_attention=L * steps, decode_attention_q8=want_q8)
        check(launches[name] == expected, f"kv_quant decode {name} launches {launches[name]}")
    check(bool(torch.isfinite(logits["int8"]).all()), "kv_quant logits not finite")
    rel = ((logits["int8"] - logits["bf16"]).abs().max() / logits["bf16"].abs().max()).item()
    stats = {"model": f"{cfg.name} kv_quant", "layers": L, "sequences": B, "steps": steps,
             "max_len": max_len, "step_ms_p50": step_ms,
             "rel_logit_err_int8_vs_bf16": rel, "launches": launches["int8"],
             "launches_bf16_cache": launches["bf16"]}
    print(f"decoded {stats['model']}: {stats}")
    check(rel < 0.05, f"kv_quant logits {rel} from the bf16 cache's (bound 0.05)")
    return stats


def decode_whisper(torch, steps: int = 64) -> dict:
    """whisper-large-v3 at its full config (32 + 32 layers, bf16): 8
    sequences over 1500 stub frames (numpy seed 0), a 4-token prompt, 64
    greedy steps; encoder, prefill and step times; flash 96 per prefill
    (32 encoder, 32 self, 32 cross), decode 64 per step (self + cross)."""
    from repro_torch.configs import get_config
    from repro_torch.models import whisper as W
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("whisper-large-v3"), param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    B, T, F = 8, 4, cfg.encdec.encoder_frames
    frames = torch.from_numpy(rng.standard_normal((B, F, cfg.d_model), np.float32)).to(DEVICE)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))).to(DEVICE),
             "frames": frames}
    W.encode(params, frames, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    W.encode(params, frames, cfg)
    torch.cuda.synchronize()
    encoder_ms = 1e3 * (time.perf_counter() - t0)

    zero_counts()
    t0 = time.perf_counter()
    logits, pre = model.prefill(params, batch)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cache = model.init_cache(B, T + steps)
    for n in ("k", "v"):
        cache["self"][n][:, :, :T] = pre["self"][n]
    cache["cross"] = pre["cross"]
    out, times = [nxt], []
    for i in range(steps):
        t0 = time.perf_counter()
        lg, _ = model.decode_step(params, cache, {"tokens": nxt, "pos": T + i})
        nxt = lg[:, -1].argmax(-1, keepdim=True)
        out.append(nxt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    L, Le = cfg.num_layers, cfg.encdec.encoder_layers
    expected = dict.fromkeys(launches, 0)
    expected.update(flash_attention=Le + 2 * L, decode_attention=2 * L * steps)
    check(launches == expected, f"whisper launches {launches} != {expected}")
    toks = torch.cat(out, dim=1).cpu()
    check(bool(torch.isfinite(lg).all()) and toks.shape == (B, steps + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "whisper decode output")
    stats = {"model": cfg.name, "layers": f"{Le} + {L}", "sequences": B, "frames": F,
             "prompt": T, "steps": steps, "encoder_ms": encoder_ms, "prefill_ms": prefill_ms,
             "step_ms_p50": 1e3 * float(np.median(times)),
             "step_ms_p90": 1e3 * float(np.percentile(times, 90)), "launches": launches}
    print(f"decoded {cfg.name}: {stats}")
    return stats


def decode_vlm(torch, steps: int = 32) -> dict:
    """internvl2-76b at full width and 2 layers (its 80 layers do not fit
    one 80 GB card in bf16): 8 sequences of 256 patch embeddings (numpy
    seed 0) and 16 text tokens, prefill, 32 greedy steps; flash 2 per
    prefill, decode 2 per step."""
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model

    cfg = dataclasses.replace(get_config("internvl2-76b"), num_layers=2, param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    B, T, P = 8, 16, cfg.vlm.num_patches
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))).to(DEVICE),
             "patch_embeds": torch.from_numpy(rng.standard_normal((B, P, cfg.d_model),
                                                                  np.float32)).to(DEVICE)}
    model.prefill(params, batch)   # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    logits, pre = model.prefill(params, batch)
    nxt = logits[:, -1].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    cache = model.init_cache(B, P + T + steps)
    for n in ("k", "v"):
        cache[n][:, :, :P + T] = pre[n]
    out, times = [nxt], []
    for i in range(steps):
        t0 = time.perf_counter()
        lg, _ = model.decode_step(params, cache, {"tokens": nxt, "pos": P + T + i})
        nxt = lg[:, -1].argmax(-1, keepdim=True)
        out.append(nxt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = read_counts()
    L = cfg.num_layers
    expected = dict.fromkeys(launches, 0)
    expected.update(flash_attention=L, decode_attention=L * steps)
    check(launches == expected, f"internvl2 launches {launches} != {expected}")
    toks = torch.cat(out, dim=1).cpu()
    check(bool(torch.isfinite(lg).all()) and toks.shape == (B, steps + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "internvl2 decode output")
    stats = {"model": cfg.name, "layers": L, "sequences": B, "patches": P, "prompt": T,
             "steps": steps, "prefill_ms": prefill_ms,
             "step_ms_p50": 1e3 * float(np.median(times)),
             "step_ms_p90": 1e3 * float(np.percentile(times, 90)), "launches": launches}
    print(f"decoded {cfg.name} (2 of 80 layers): {stats}")
    return stats


def graphed_blocks(torch, eng, block, label: str, attn_layers: int) -> dict:
    """``step_many(16)`` as CUDA-graph replays against 16 eager ``step()``
    calls from one state of ``eng`` (every slot greedy, ``block`` admitted):
    the engine's first block captures the greedy step after one eager step
    and replays 15, a second block from the same state replays all 16.
    Both token-identical to the eager steps, decode attention launched
    exactly ``attn_layers`` x 16 times a block, every block on the replay
    path; then a graphed block under the profiler must show the graph's
    decode-attention kernels among the device's events.  Returns the
    capture's wall time, the graph's pool bytes and the profiled block."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import trace
    from repro_torch.kernels import decode_attention as dec

    check(eng.key_greedy not in eng.graphs, f"{label}: a graph was captured before the check")
    snap = _snapshot(eng)
    spans0 = trace.snapshot()
    blocks = []
    for i in range(2):
        if i:
            _restore(eng, snap)
            spans1 = trace.snapshot()   # the second block replays every step
        before = dec.launches
        blk = eng.step_many(16)
        torch.cuda.synchronize()
        blocks.append((blk, {r.rid: list(eng.outputs[r.rid]) for r in block},
                       dec.launches - before))
    end = trace.snapshot()
    spans = {k: v - spans0.get(k, 0) for k, v in end.items()}
    _restore(eng, snap)
    seq = []
    for _ in range(16):
        seq.extend(eng.step())
    want = {r.rid: list(eng.outputs[r.rid]) for r in block}
    for i, (blk, got, _) in enumerate(blocks):
        check(blk == seq and got == want,
              f"{label}: graphed step_many(16) (block {i + 1}) differs from 16 step() calls")
    check([n for _, _, n in blocks] == [16 * attn_layers] * 2,
          f"{label}: graphed blocks launched decode attention {[n for _, _, n in blocks]} "
          f"times, not {16 * attn_layers} each")
    check((spans.get("span.engine.capture.count"), spans.get("span.engine.replay.count"),
           spans.get("span.engine.replay.units")) == (1, 2, 31),
          f"{label}: capture/replay spans {spans}")
    g = eng.graphs[eng.key_greedy].graph
    pool = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == tuple(g.pool())]
    # one more graphed block, profiled: the replays' kernels are the
    # device's events (the benchmark's rooflines read them there)
    snap = _snapshot(eng)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step_many(16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _restore(eng, snap)
    dev = [(e.name(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
           if e.device_type().name == "CUDA" and not e.is_hidden_event()]
    n_decode = sum(1 for n, _ in dev if "decode_kernel" in n or "decode_q8" in n)
    check(n_decode == 16 * attn_layers,
          f"{label}: the profiler saw {n_decode} decode-attention kernels in a graphed "
          f"block, not {16 * attn_layers}")
    out = {"capture_s": spans["span.engine.capture.wall_ns"] / 1e9,
           "graph_pool_bytes": sum(pool) if pool else None,
           "dispatch_ms_per_step_replayed": (end["span.engine.dispatch.wall_ns"]
                                             - spans1["span.engine.dispatch.wall_ns"]) / 1e6 / 16,
           "profiled_block": {"wall_ms": 1e3 * wall, "device_ops": len(dev),
                              "device_busy_ms": sum(d for _, d in dev) / 1e6,
                              "decode_attention_kernels": n_decode}}
    print(f"{label}: graphed step_many(16) token-identical to 16 step() calls; {out}")
    return out


def profile_window(torch, fn, n: int, windows: int = 1, top: int = 10) -> dict:
    """Device time of ``n`` calls of ``fn`` (decode steps, admissions) under
    ``torch.profiler``: wall time per call, device busy time per call
    (kernel time summed over the window), device operations (kernels and
    copies) per call, the idle share, and the kernels that take the most
    time.  A window in which the profiler recorded no device time is run
    again, up to ``windows`` in all (only where repeating ``fn`` changes no
    count that is checked)."""
    from torch.profiler import ProfilerActivity, profile

    for window in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the device's activities (kernels, copies, sets) summed by name from
        # the profiler's raw events: what key_averages() gives for them,
        # without building its event tree (~0.2 ms an event: minutes for an
        # xLSTM admission's ~150 k launches)
        by_name: dict[str, list] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type().name == "CUDA" and not e.is_hidden_event():
                acc = by_name.setdefault(e.name(), [0, 0])
                acc[0] += e.duration_ns() / 1e3
                acc[1] += 1
        busy_us = sum(us for us, _ in by_name.values())
        if busy_us > 0:
            break
        print(f"profiler window {window + 1} of {windows} recorded no device time")
    check(busy_us > 0, "the profiler saw no device time in the window")
    top = sorted(by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:top]
    return {
        "calls": n,
        "wall_ms_per_call": 1e3 * wall / n,
        "device_busy_ms_per_call": busy_us / 1e3 / n,
        "device_ops_per_call": sum(c for _, c in by_name.values()) / n,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall,
        "top_kernels_ms_per_call": {name[:80]: us / 1e3 / n for name, (us, _) in top},
    }


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _snapshot(eng):
    from repro_torch.models.api import tree_map

    p = eng.payload
    return (tree_map(lambda t: t.clone(), p["cache"]), p["tokens"].clone(),
            p["pos"].clone(), list(eng.slot_req), eng.slot_remaining.copy(),
            {r: list(t) for r, t in eng.outputs.items()})


def _restore(eng, snap):
    from repro_torch.models.api import tree_map

    cache, tokens, pos, slot_req, remaining, outputs = snap
    tree_map(lambda dst, src: dst.copy_(src), eng.payload["cache"], cache)
    eng.payload["tokens"].copy_(tokens)
    eng.payload["pos"].copy_(pos)
    eng.slot_req, eng.slot_remaining = list(slot_req), remaining.copy()
    eng.outputs = {r: list(t) for r, t in outputs.items()}   # the snapshot serves again


def release(torch) -> None:
    """Free what a finished phase left on the card (the engine's timing
    wrappers form a reference cycle, so collect before emptying the cache)."""
    gc.collect()
    torch.cuda.empty_cache()


# -- phase 6: cluster serving through the HAM runtime ------------------------


def cluster_serve(torch) -> dict:
    """internlm2-20b at full config in bf16 through the port's
    ``ClusterServingEngine`` (2 thread workers x 4 slots, ``max_len`` 2048),
    worker-driven (decode blocks of 16), lockstep, and worker-driven on one
    worker of 4 slots, against one 4-slot ``ServingEngine`` on the same 16
    requests: token-identical transcripts, exact launch counts, tokens/s,
    TTFT and host RPCs per emitted token for each."""
    from repro_torch.configs import get_config
    from repro_torch.core import migratable as mig
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ClusterServingEngine, Request, ServingEngine
    from repro_torch.serve.handlers import _NODE_ENGINES, MAX_PROMPT

    # a CUDA tensor travels as the bytes of its host copy (pinned staging)
    t = torch.arange(48, dtype=torch.float32, device=DEVICE).reshape(6, 8)
    check(mig.pack_dynamic([t, {"t": t}]) == mig.pack_dynamic([t.cpu(), {"t": t.cpu()}]),
          "a CUDA tensor packs to other bytes than its CPU copy")

    w, slots, max_len, block = CLUSTER["workers"], CLUSTER["slots"], 2048, 16
    n_req, new = CLUSTER["requests"], CLUSTER["new_tokens"]
    cfg = dataclasses.replace(get_config("internlm2-20b"), param_dtype="bfloat16")
    model = build_model(cfg)
    params = model.init(seed=0)
    rng = np.random.default_rng(0)
    # prompt + budget within the wire bound on an admission prompt: a
    # worker-driven continuation re-admits prompt + every emitted token
    lengths = rng.integers(64, MAX_PROMPT - new + 1, n_req)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]

    def requests(rid0=0, k=n_req, budget=new):
        return [Request(prompt=prompts[i % n_req], max_new_tokens=budget, rid=rid0 + i)
                for i in range(k)]

    # TTFT is read on the host for every leg: when a request's first token
    # is in the host's hands, from the start of the drive
    def single_first(eng):
        """The single engine's admission ends on its first token's host
        transfer, on the driving thread."""
        first: dict[int, float] = {}
        admit = eng.admit

        def timed_admit(req, slot):
            admit(req, slot)
            first[req.rid] = time.monotonic()
        eng.admit = timed_admit
        return lambda: first

    def lockstep_first(sched):
        """Lockstep: the admit's reply carries the first token; its future
        resolves when the reply is dispatched on the host (admits are the
        only calls routed by session)."""
        first: dict[int, float] = {}
        submit = sched.submit

        def timed_submit(fn, *args, session=None, **kw):
            fut = submit(fn, *args, session=session, **kw)
            if session is not None:
                rid = int(session.split("/")[1])
                fut.add_done_callback(lambda f: first.setdefault(rid, time.monotonic()))
            return fut
        sched.submit = timed_submit
        return lambda: first

    def streamed_first(eng):
        """Worker-driven: the host's stream handler stamps ``t_first`` when
        the first token lands in the request's host transcript."""
        return lambda: {rid: ev["t_first"] for rid, ev in eng._events.items()
                        if rid < n_req and "t_first" in ev}

    def drive(name, engines, run, first_tokens, sched=None):
        steps0 = sum(e.steps_dispatched for e in engines)
        rpc0 = 0 if sched is None else sched.stats["submitted"] + sched.stats["oneways"]
        routed0 = {} if sched is None else dict(sched.stats["routed"])
        zero_counts()
        t0 = time.monotonic()
        out = run(requests())
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        first = first_tokens()
        launches = read_counts()
        steps = sum(e.steps_dispatched for e in engines) - steps0
        tokens = sum(len(v) for v in out.values())
        check(sorted(out) == list(range(n_req)) and all(len(v) == new for v in out.values()),
              f"{name}: served {sorted(out)} with {sorted(len(v) for v in out.values())} tokens")
        check(sorted(first) == list(range(n_req)),
              f"{name}: first tokens of {sorted(first)} reached the host")
        L = cfg.num_layers
        expected = dict.fromkeys(launches, 0)
        expected.update(decode_attention=L * steps, flash_attention=L * n_req)
        check(launches == expected, f"{name}: launches {launches} != {expected} "
              f"({steps} decode steps, {n_req} admissions)")
        ttft = sorted(1e3 * (first[r] - t0) for r in range(n_req))
        stats = {"tokens": tokens, "wall_s": wall, "tokens_per_s": tokens / wall,
                 "ttft_ms_p50": float(np.median(ttft)), "ttft_ms_max": ttft[-1],
                 "decode_steps": steps, "admissions": n_req, "launches": launches}
        if sched is not None:
            rpcs = sched.stats["submitted"] + sched.stats["oneways"] - rpc0
            stats.update(host_rpcs=rpcs, host_rpcs_per_token=rpcs / tokens,
                         routed={n: c - routed0.get(n, 0)
                                 for n, c in sched.stats["routed"].items()})
        return out, stats

    def margin(rid, pos, a, b):
        """Logit of token a minus token b at the first differing position,
        from one prefill of the prompt and the common prefix."""
        prefix = np.concatenate([prompts[rid], np.asarray(single_out[rid][:pos])])
        tokens = torch.from_numpy(prefix[None, :].astype(np.int64)).to(DEVICE)
        logits, _ = model.prefill(params, {"tokens": tokens})
        last = logits[0, -1].float()
        return float(last[a] - last[b])

    def same(name, out):
        for rid in range(n_req):
            got, want = out[rid], single_out[rid]
            if got != want:
                pos = next(i for i, (g, x) in enumerate(zip(got, want)) if g != x)
                check(False, f"{name}: request {rid} (prompt {len(prompts[rid])} tokens) "
                      f"differs from the single engine at token {pos}: {got[pos]} against "
                      f"{want[pos]}, logit margin {margin(rid, pos, got[pos], want[pos]):.4g}")

    # the single engine, on this (the main) thread, as phase 5 drives it
    eng = ServingEngine(model, params, num_slots=slots, max_len=max_len)
    eng.run(requests(1000, 2, block + 1))                 # warm-up
    eng.outputs.clear()
    single_out, single = drive("single engine", [eng], eng.run, single_first(eng))
    del eng
    release(torch)
    stats = {"model": cfg.name, "layers": cfg.num_layers, "dtype": "bfloat16",
             "workers": w, "slots_per_worker": slots, "max_len": max_len,
             "requests": n_req, "new_tokens": new, "prompt_tokens": int(lengths.sum()),
             "decode_block": block, "single_engine": single}
    # the third leg, one worker of as many slots as the single engine, tells
    # the runtime's own cost from the two replicas' contention
    for mode, worker_driven, workers in (("worker_driven", True, w), ("lockstep", False, w),
                                         ("worker_driven_1_worker", True, 1)):
        eng = ClusterServingEngine(model, params, num_workers=workers, slots_per_worker=slots,
                                   max_len=max_len, worker_driven=worker_driven,
                                   decode_block=block)
        try:
            replicas = [_NODE_ENGINES[k] for k in eng._engine_keys.values()]
            check(len(replicas) == workers and all(r.params is params for r in replicas),
                  f"{mode}: replicas do not share one copy of the params")
            # warm-up: workers x slots requests fill every replica (a thread's
            # first cuBLAS call sets up its handle)
            eng.run(requests(1000, workers * slots, block + 1), timeout=600)
            first = streamed_first(eng) if worker_driven else lockstep_first(eng.sched)
            out, st = drive(mode, replicas, lambda r: eng.run(r, timeout=900), first,
                            eng.sched)
            # worker-driven decode blocks replay each replica's captured step
            st["graphed_replicas"] = sum(r.key_greedy in r.graphs for r in replicas)
            check(st["graphed_replicas"] == (workers if worker_driven else 0),
                  f"{mode}: {st['graphed_replicas']} of {workers} replicas captured a graph")
        finally:
            eng.close()
        del replicas, eng
        check(len(st["routed"]) == workers and all(n > 0 for n in st["routed"].values()),
              f"{mode}: not every worker served ({st['routed']})")
        same(mode, out)
        stats[mode] = st
        release(torch)
    check(stats["worker_driven"]["host_rpcs_per_token"] < 0.1,
          f"worker-driven host RPCs per token {stats['worker_driven']['host_rpcs_per_token']}")
    print(f"cluster serving {cfg.name}: " + ", ".join(
        f"{m} {stats[m]['tokens_per_s']:.1f} tokens/s, TTFT p50 {stats[m]['ttft_ms_p50']:.1f} ms"
        + (f", {stats[m]['host_rpcs_per_token']:.4f} host RPCs/token"
           if "host_rpcs" in stats[m] else "")
        for m in ("single_engine", "worker_driven", "lockstep", "worker_driven_1_worker")))
    return stats


# -- phase 8: training on the card --------------------------------------------

# flash backward: max |kernel - plain| <= tol x rms(plain) for each of dq,
# dk, dv.  The scale is the gradient's RMS, not its largest entry: under a
# causal mask the gradients pile up at the first keys and queries, and a
# limit relative to those would pass a kernel wrong on the later tiles.
# Each limit lies between the largest reading of the sound kernel and what
# a backward that skips one 64-wide tile reads (`skipped_tile_grads`); the
# script checks both sides.  On an H100 80GB HBM3 at 700 W the sound kernel
# read at most 0.294 in bf16 (the size of one bf16 ulp of the largest dv
# entries) and 2.8e-4 in float32; a skipped tile read at least 1.26 (d 192's
# dv) in either dtype.
GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.5}
# grouped-matmul backward: |kernel - plain| <= atol s + rtol |plain|, s =
# max(1, rms(plain)).  dx and dw contract over f and C instead of d, and dw
# is O(sqrt(C)), not O(1): the float32 sums' rounding grows with their
# partial sums, i.e. with s (C 1280's dw, s ~ 36, differed by 3.8e-4 on an
# H100 80GB HBM3 at 700 W), so the forward's limits are in units of s,
# with a 1e-5 relative term for float32
GMM_BWD_TOL = {"float32": (2e-5, 1e-5), "bfloat16": (2e-2, 1e-2)}
# (what, E, C, d, f, seed): olmoe's serving prefill (C 160), a ragged C, and
# its training step at B 4 x S 2048 (G 2 x C 640 folded into C 1280):
# gate/up d 2048 -> f 1024 and down d 1024 -> f 2048
GMM_BWD_CASES = [
    ("prefill", 64, 160, 2048, 1024, 760),
    ("ragged", 64, 37, 2048, 1024, 637),
    ("train_gate", 64, 1280, 2048, 1024, 1880),
    ("train_down", 64, 1280, 1024, 2048, 1881),
]
# the forward's row log-sum-exp against the plain one (float32 logsumexp of
# the same scaled, masked scores): |kernel - plain| <= LSE_ATOL; the values
# are ~log(keys) + a few, and float32 sums over d in another order differ
# by ~1e-6
LSE_ATOL = 1e-3
# phase 3's flash shapes (key, B, H, Hkv, S, Skv, d, causal), at which the
# forward is timed with and without its LSE output
FLASH_LSE_TIMED = [
    ("d128", 1, 48, 8, 1024, 1024, 128, True), ("olmoe", 1, 16, 16, 1024, 1024, 128, True),
    ("d80", 1, 32, 32, 1024, 1024, 80, True), ("whisper_encoder", 8, 20, 20, 1500, 1500, 64, False),
    ("whisper_cross", 1, 20, 20, 448, 1500, 64, False), ("d192", 1, 96, 8, 1024, 1024, 192, True),
]
# (what, B, H, Hkv, S, Skv, d, causal, window): the attention shapes of the
# trained and served configs
FLASH_BWD_CASES = [
    ("internlm2", 1, 48, 8, 2048, 2048, 128, True, None),
    ("zamba2_d80", 1, 32, 32, 1024, 1024, 80, True, None),
    ("whisper_encoder", 8, 20, 20, 1500, 1500, 64, False, None),
    ("whisper_cross", 1, 20, 20, 448, 1500, 64, False, None),
    ("window", 1, 32, 32, 1024, 1024, 80, True, 256),
    ("ragged", 1, 48, 8, 509, 509, 128, True, None),
    ("d192", 1, 96, 8, 1024, 1024, 192, True, None),
]
# mLSTM and SSD backward: max |kernel - plain| <= tol x rms(plain) for each
# gradient, as the flash backward.  Each limit lies between the largest
# reading of the sound kernel and what a backward that skips one chunk
# reads (`skipped_chunk_grads`); the script checks both sides.  On an H100
# 80GB HBM3 at 700 W the sound kernels read at most 0.105 in bf16 (the
# mLSTM's dq: one bf16 rounding of its largest entries) and 3.1e-4 in
# float32 (the SSD's dx); a skipped chunk read at least 1.1 (the SSD's dD).
SCAN_GRAD_TOL = {"float32": 1e-3, "bfloat16": 0.5}
# (what, B, H, S, dk, dv, chunk): xlstm-1.3b's training step (B 4 x S
# 2048) and a ragged length; q and k |N(0, 1)| as phase 3 draws them
MLSTM_BWD_CASES = [
    ("train", 4, 4, 2048, 512, 1024, 256),
    ("ragged", 1, 4, 509, 512, 1024, 256),
]
# (what, B, S, H, G, chunk, views): zamba2-2.7b's training step (x, B and C
# views of one conv output, as the Mamba2 block passes them) and a ragged
# length; N = P = 64
SSD_BWD_CASES = [
    ("train", 4, 2048, 80, 1, 256, True),
    ("ragged", 1, 509, 80, 1, 256, False),
]
# gradients card vs CPU, float32, one step at B 1 x S 128: |card - CPU| <=
# rtol x max |CPU| of each leaf (sums over d 6144 / 16384 in another order,
# as phase 4's logits; a leaf's small entries carry its large ones' error)
CARD_CPU_GRAD_RTOL = 1e-3
# card vs CPU over WITNESS_STEPS trainer steps at the lr phase 8b first
# used: per-step losses within 1e-3 relative in float32 (step 1 agrees to
# ~1e-7; Adam's sign-like first steps only amplify the gradients' float32
# reassociation in the entries nearest zero); the published numerics (bf16
# compute, full remat) on the card within 5% of the float32 CPU's (bf16
# keeps 8 bits; a step that doubles the loss is a 100% move).  Two steps:
# the rise shows at step 2, and each float32 CPU step of two full-width
# internlm2-20b layers takes ~30 s of the script's time limit
WITNESS_OPT = dict(lr=1e-3, warmup_steps=5)
WITNESS_STEPS = 2
WITNESS_RTOL = {"float32": 1e-3, "bfloat16": 5e-2}
# phase 8b: (arch, witness steps, layers) held card against CPU; xlstm-1.3b
# at one full group (7 mLSTM + 1 sLSTM: `_group_counts` takes multiples of
# 8), zamba2-2.7b at 6 Mamba2 blocks and one application of the shared
# attention (`zamba2._group_counts` takes multiples of attn_every)
CARD_VS_CPU = (("internlm2-20b", WITNESS_STEPS, 2), ("olmoe-1b-7b", 0, 2), ("xlstm-1.3b", 0, 8),
               ("zamba2-2.7b", 0, 6))
# phase 8b/8c: (arch, layers, steps); xlstm-1.3b takes 2 steps of ~7 s
# (its sLSTM loop), for the script's time limit; 8d: a narrow
# internlm2-shaped config
TRAINED = (("internlm2-20b", 2, 12), ("olmoe-1b-7b", 2, 12), ("xlstm-1.3b", 8, 2),
           ("zamba2-2.7b", 6, 12))
TRAIN_BATCH, TRAIN_SEQ = 4, 2048
# Adam's first steps move every weight by about lr (m / sqrt(v) = sign g),
# so each step shifts every logit by ~0.8 d lr through the head: at d 6144
# lr 1e-3 sent internlm2-20b's loss from 11.8 to 22.6 and never back below
# 11.8 in 12 steps (card_vs_cpu runs that rate from one set of params on
# the card and on the CPU, the witness that the rise is not the card's);
# lr 1e-4 moves a logit ~0.5 a step
TRAIN_OPT = dict(lr=1e-4, warmup_steps=5)
RESTART = dict(num_layers=2, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1024)


def flash_grads(torch, B, H, Hkv, S, Skv, d, dtype, causal, window, seed):
    """Model-layout q/k/v and a dO; the forward kernel writes o and the rows'
    log-sum-exp, as under autograd; returns (inputs, lse, kernel grads,
    plain grads), the grads as (B, heads, S, d) views."""
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=DEVICE).manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda *shape: torch.randn(*shape, generator=g, device=DEVICE).to(dt).transpose(1, 2)
    q, k, v, do = mk(B, S, H, d), mk(B, Skv, Hkv, d), mk(B, Skv, Hkv, d), mk(B, S, H, d)
    lse = fa.empty_lse(q)
    o = fa._launch(q, k, v, causal, window, lse)
    got = fa.flash_attention_heads_backward(q, k, v, o, do, causal=causal, window=window, lse=lse)
    want = fa.flash_attention_heads_backward_plain(q, k, v, o, do, causal=causal, window=window)
    torch.cuda.synchronize()
    return (q, k, v, o, do), lse, got, want


def grad_errs(torch, got, want):
    """max |got - want| / rms(want) of each pair."""
    return [max_err(torch, a, b) / b.float().square().mean().sqrt().item()
            for a, b in zip(got, want)]


def skipped_tile_grads(torch, q, k, v, do, want, causal, window):
    """What a backward that skips one 64-wide tile gives: ``want``'s dq
    without the middle key tile's share, and its dk and dv without the
    middle query tile's, the shares taken from the float32 attention of
    these inputs."""
    B, H, S, d = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    rep, scale = H // Hkv, d ** -0.5
    qf, dof = q.float(), do.float()
    kf, vf = (t.float().repeat_interleave(rep, 1) for t in (k, v))
    s = qf @ kf.transpose(-1, -2) * scale
    if causal:
        mask = torch.ones(S, Skv, dtype=torch.bool, device=DEVICE).tril()
        if window:
            mask = mask.triu(1 - window)
        s.masked_fill_(~mask, float("-inf"))
    p = torch.softmax(s, -1)
    del s
    ds = p * (dof @ vf.transpose(-1, -2) - (dof * (p @ vf)).sum(-1, keepdim=True))
    tk = slice(Skv // 2 // 64 * 64, Skv // 2 // 64 * 64 + 64)
    tq = slice(S // 2 // 64 * 64, S // 2 // 64 * 64 + 64)
    group = lambda t: t.view(B, Hkv, rep, Skv, d).sum(2)
    parts = (ds[..., tk] @ kf[:, :, tk] * scale,
             group(ds[:, :, tq].transpose(-1, -2) @ qf[:, :, tq] * scale),
             group(p[:, :, tq].transpose(-1, -2) @ dof[:, :, tq]))
    return [w.float() - part for w, part in zip(want, parts)]


def mlstm_bwd_flops(S: int, chunk: int, dk: int, dv: int) -> int:
    """Operations of one (sequence, head) of the mLSTM gradient as the
    function needs them (the forward's states at chunk starts taken as
    given): per chunk of n positions, P = q k^T and D = dh v^T again, and dq
    = dS k, dk = dS^T q, dv = P^T dh, on and below the diagonal, n(n+1)/2 x
    2(3 dk + 2 dv); and four state products, dq's G C^T, dk's v dC^T, dv's k
    dC and the carried dC's q^T G, 2n dk dv each."""
    ns = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    return sum(n * (n + 1) * (3 * dk + 2 * dv) + 8 * n * dk * dv for n in ns)


def ssd_bwd_flops(S: int, chunk: int, N: int, P: int) -> tuple[int, int]:
    """(per head, per group) operations of the SSD gradient as the function
    needs them: per chunk of n positions and head, dM = dy x^T, dx = M^T dy
    (2P deep), dC = dCB B and dB = dCB^T C (2N deep) on and below the
    diagonal, n(n+1)/2 x 2(2P + 2N), and four state products (the carried
    dh, dx's, dC's and dB's), 2n N P each; per group, C B^T, n(n+1)/2 x 2N."""
    ns = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    return (sum(n * (n + 1) * (2 * P + 2 * N) + 8 * n * N * P for n in ns),
            sum(n * (n + 1) * N for n in ns))


def skipped_chunk_grads(backward_plain, dout, seq_dim, span, *args, **kw):
    """What a backward that skips one chunk of ``span`` positions gives: the
    plain gradient with the middle chunk's output gradient zeroed."""
    S = dout.shape[seq_dim]
    c0 = -(-S // span) // 2 * span
    cut = dout.clone()
    cut.narrow(seq_dim, c0, min(span, S - c0)).zero_()
    return backward_plain(*args, cut, **kw)


def check_scan_grads(torch) -> dict:
    """Phase 8a's chunked scans: the mLSTM and SSD backward kernels against
    autograd through their plain versions on the card, float32 and bf16, at
    the training shapes and a ragged length; repeated calls bit for bit;
    timed beside bound and plain (no single PyTorch call computes either
    gradient, so the library column is none)."""
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import mlstm

    print(f"mLSTM and SSD backward tolerance: max |kernel - plain| <= tol x rms(plain), tol "
          f"{SCAN_GRAD_TOL}; a backward that skips one chunk must read above it")
    records = {}
    names = {"mlstm": ("dq", "dk", "dv", "di", "df"),
             "ssd": ("dx", "ddt", "dA", "dB", "dC", "dD")}

    def judge(kind, what, shape, dt, got, want, wrong, again):
        errs = grad_errs(torch, got, want)
        ok = max(errs) <= SCAN_GRAD_TOL[dt] < min(wrong)
        print(f"{kind}_backward {what} {shape} {dt}: max err / rms "
              f"{dict(zip(names[kind], (f'{e:.3g}' for e in errs)))}; one chunk skipped "
              f"{dict(zip(names[kind], (f'{e:.3g}' for e in wrong)))}; limit "
              f"{SCAN_GRAD_TOL[dt]} between them: {ok}")
        check(max(errs) <= SCAN_GRAD_TOL[dt],
              f"{kind}_backward {what} {dt} disagrees with its plain version: {errs}")
        check(SCAN_GRAD_TOL[dt] < min(wrong),
              f"{kind}_backward {what} {dt}: the limit would pass a skipped chunk: {wrong}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{kind}_backward {what} {dt}: a second call differs")
        return max(max_err(torch, a, b) for a, b in zip(got, want))

    for i, (what, B, H, S, dk, dv, chunk) in enumerate(MLSTM_BWD_CASES):
        for dt in ("bfloat16", "float32"):
            g = torch.Generator(device=DEVICE).manual_seed(900 + i)
            tdt = getattr(torch, dt)
            q = torch.randn(B, S, H, dk, generator=g, device=DEVICE).abs().to(tdt)
            k = torch.randn(B, S, H, dk, generator=g, device=DEVICE).abs().to(tdt)
            v = torch.randn(B, S, H, dv, generator=g, device=DEVICE).to(tdt)
            gates = torch.randn(B, S, 2 * H, generator=g, device=DEVICE)
            gates[..., H:] += 2.0
            xs = [t.transpose(1, 2) for t in (q, k, v, *gates.to(tdt).chunk(2, dim=-1))]
            dh = torch.randn(B, H, S, dv, generator=g, device=DEVICE).to(tdt)
            got = mlstm.mlstm_chunked_heads_backward(*xs, dh, chunk=chunk)
            want = mlstm.mlstm_chunked_heads_backward_plain(*xs, dh, chunk=chunk)
            wrong = grad_errs(torch, skipped_chunk_grads(
                mlstm.mlstm_chunked_heads_backward_plain, dh, 2, chunk, *xs,
                chunk=chunk), want)
            again = mlstm.mlstm_chunked_heads_backward(*xs, dh, chunk=chunk)
            route = mlstm.backward_route(xs[0], xs[2], chunk)
            shape = f"B={B} H={H} S={S} dk={dk} dv={dv} chunk={chunk} route {route}"
            err = judge("mlstm", what, shape, dt, got, want, wrong, again)
            del again, want
            if what != "train":   # timed at the training shape only
                del xs, dh, got
                continue
            key = "mlstm_backward" + ("_f32" if dt == "float32" else "")
            es = q.element_size()
            nbytes = es * (4 * q.numel() + 3 * v.numel() + 4 * B * S * H)
            rec = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: mlstm.mlstm_chunked_heads_backward(
                    *xs, dh, chunk=chunk), 3),
                plain_ms=time_ms(torch, lambda: mlstm.mlstm_chunked_heads_backward_plain(
                    *xs, dh, chunk=chunk), 2),
                library_ms=None, library="none (no single PyTorch call computes it)",
                shape=f"{shape} {dt}",
            )
            rec["bound_ms"], rec["bound_by"] = bound(
                nbytes, B * H * mlstm_bwd_flops(S, chunk, dk, dv), dt)
            if route == "tensor_cores":
                # the CUDA-core route on the same inputs, timed and profiled
                # beside the tensor-core one, pass by pass
                cc = lambda: mlstm._launch_backward(*xs, dh, chunk, kernel="cuda_cores")
                tcr = lambda: mlstm.mlstm_chunked_heads_backward(*xs, dh, chunk=chunk)
                turns = [time_ms(torch, fn, 3) for fn in (cc, tcr, tcr, cc)]
                rec["previous"] = {"route": "cuda_cores", "ms": (turns[0] + turns[3]) / 2,
                                   "turns_ms": turns}
                rec["passes_ms"] = {
                    "tensor_cores": passes_ms(torch, tcr, MLSTM_BWD_TC,
                                                     (turns[1] + turns[2]) / 2),
                    "cuda_cores": passes_ms(torch, cc, MLSTM_BWD_CC,
                                                   rec["previous"]["ms"])}
                print(f"mlstm_backward {what} {dt}: tensor cores {(turns[1] + turns[2]) / 2:.3f} "
                      f"ms, CUDA cores {rec['previous']['ms']:.3f} ms (turns "
                      f"{[f'{t:.3f}' for t in turns]}); device ms a call by pass "
                      f"{rec['passes_ms']}")
            records[key] = rec
            print(f"mlstm_backward {shape} {dt}: {rec['ms']:.3f} ms, plain {rec['plain_ms']:.3f} "
                  f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: the function's "
                  f"products, mlstm_bwd_flops, and its inputs read and gradients written once)")
            del xs, dh, got
            release(torch)

    for i, (what, B, S, H, G, chunk, views) in enumerate(SSD_BWD_CASES):
        for dt in ("bfloat16", "float32"):
            g = torch.Generator(device=DEVICE).manual_seed(950 + i)
            tdt = getattr(torch, dt)
            xs = ssd_inputs(torch, B, S, H, G, 64, 64, tdt, g, views)
            dy = torch.randn(B, S, H, 64, generator=g, device=DEVICE).to(tdt)
            got = ssd.ssd_chunked_backward(*xs, dy, chunk=chunk)
            want = ssd.ssd_chunked_backward_plain(*xs, dy, chunk=chunk)
            wrong = grad_errs(torch, skipped_chunk_grads(
                ssd.ssd_chunked_backward_plain, dy, 1, chunk, *xs, chunk=chunk), want)
            again = ssd.ssd_chunked_backward(*xs, dy, chunk=chunk)
            route = ssd.backward_route(xs[0], xs[3], chunk)
            shape = f"B={B} S={S} H={H} G={G} N=P=64 chunk={chunk} views={views} route {route}"
            err = judge("ssd", what, shape, dt, got, want, wrong, again)
            del again, want
            if what != "train":
                del xs, dy, got
                continue
            key = "mamba2_ssd_backward" + ("_f32" if dt == "float32" else "")
            x, dts, A, Bm, Cm, D = xs
            es = x.element_size()
            nbytes = es * (3 * x.numel() + 4 * B * S * G * 64) + 4 * (2 * dts.numel() + 4 * H)
            per_head, per_group = ssd_bwd_flops(S, chunk, 64, 64)
            rec = dict(
                max_abs_err=err,
                ms=time_ms(torch, lambda: ssd.ssd_chunked_backward(*xs, dy, chunk=chunk), 5),
                plain_ms=time_ms(torch, lambda: ssd.ssd_chunked_backward_plain(
                    *xs, dy, chunk=chunk), 2),
                library_ms=None, library="none (no single PyTorch call computes it)",
                shape=f"{shape} {dt}",
            )
            rec["bound_ms"], rec["bound_by"] = bound(
                nbytes, B * (H * per_head + G * per_group), dt)
            route = ssd.backward_route(x, Bm, chunk)
            rec["route"] = route
            if route == "tensor_cores":
                # the CUDA-core route on the same inputs, in turns, by pass;
                # both routes' scratch
                cc = lambda: ssd._launch_backward(*xs, dy, chunk, kernel="cuda_cores")
                tcr = lambda: ssd.ssd_chunked_backward(*xs, dy, chunk=chunk)
                turns = [time_ms(torch, fn, 5) for fn in (cc, tcr, tcr, cc)]
                rec["previous"] = {"route": "cuda_cores", "ms": (turns[0] + turns[3]) / 2,
                                   "turns_ms": turns}
                rec["passes_ms"] = {
                    "tensor_cores": passes_ms(torch, tcr, SSD_BWD_TC, (turns[1] + turns[2]) / 2),
                    "cuda_cores": passes_ms(torch, cc, SSD_BWD_CC, rec["previous"]["ms"])}
                rec["workspace_bytes"] = {
                    r: ssd.backward_workspace(x, Bm, chunk, r)
                    for r in ("tensor_cores", "cuda_cores")}
                tcp = rec["passes_ms"]["tensor_cores"]
                gates_ms = (tcp["gates<"] + tcp["gates_bwd"]
                            if all(isinstance(tcp[k], float) for k in ("gates<", "gates_bwd"))
                            else "not measured")
                rec["gate_passes_ms"] = gates_ms
                print(f"mamba2_ssd_backward {what} {dt}: tensor cores "
                      f"{(turns[1] + turns[2]) / 2:.4f} ms, CUDA cores {rec['previous']['ms']:.4f} "
                      f"ms (turns {[f'{t:.4f}' for t in turns]}); device ms a call by pass "
                      f"{rec['passes_ms']}; gate passes (gates + gates_bwd) {gates_ms}; scratch "
                      f"bytes {rec['workspace_bytes']}")
                check((turns[1] + turns[2]) / 2 < rec["previous"]["ms"],
                      f"mamba2_ssd_backward {what}: the tensor-core route is not faster than "
                      f"the CUDA-core route it replaced: {turns}")
            records[key] = rec
            print(f"mamba2_ssd_backward {shape} {dt}: {rec['ms']:.3f} ms, plain "
                  f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                  f"x, B, C, dt, dy read and every gradient written once; ssd_bwd_flops)")
            del xs, dy, got
            release(torch)
    return records


def flash_lse_cost(torch) -> dict:
    """The forward at phase 3's shapes (bf16) with and without its LSE
    output, timed in turns (without, with, with, without): what saving the
    LSE costs a training forward, and the serving build (no LSE) beside
    phase 3's times."""
    from repro_torch.kernels import flash_attention as fa

    out = {}
    for i, (key, B, H, Hkv, S, Skv, d, causal) in enumerate(FLASH_LSE_TIMED):
        g = torch.Generator(device=DEVICE).manual_seed(40 + i)
        mk = lambda *shape: torch.randn(*shape, generator=g, device=DEVICE).to(
            torch.bfloat16).transpose(1, 2)
        q, k, v = mk(B, S, H, d), mk(B, Skv, Hkv, d), mk(B, Skv, Hkv, d)
        lse = fa.empty_lse(q)
        plain = lambda: fa._launch(q, k, v, causal, None)
        saving = lambda: fa._launch(q, k, v, causal, None, lse)
        turns = [time_ms(torch, fn, 20) for fn in (plain, saving, saving, plain)]
        out[key] = {"shape": f"B={B} H={H} Hkv={Hkv} S={S} Skv={Skv} d={d} causal={causal} "
                             f"bfloat16",
                    "no_lse_ms": (turns[0] + turns[3]) / 2, "lse_ms": (turns[1] + turns[2]) / 2,
                    "turns_ms": turns}
        print(f"flash_attention forward {key}: no lse {out[key]['no_lse_ms']:.4f} ms, with lse "
              f"{out[key]['lse_ms']:.4f} ms (turns {[f'{t:.4f}' for t in turns]})")
        del q, k, v, lse
    release(torch)
    return out


def gmm_bwd_copies_by_pass(torch, x, w, dy) -> dict:
    """The replaced (copies) path's passes, each timed alone: the w^T
    contiguous copy, the zero-and-copy of the padded x^T, and the forward
    kernel's dx and dw products on those copies."""
    from repro_torch.kernels import grouped_matmul as gmm

    (_, wt), (xt, _) = gmm.backward_operands(x, w, dy)
    E, C, d = x.shape

    def padded_xt():
        buf = torch.zeros((E, d, -(-C // 8) * 8), dtype=x.dtype, device=x.device)
        buf[:, :, :C].copy_(x.transpose(1, 2))

    out = {"w_t_copy": time_ms(torch, lambda: w.transpose(1, 2).contiguous(), 10),
           "x_t_pad_copy": time_ms(torch, padded_xt, 10),
           "dx_product": time_ms(torch, lambda: gmm._launch(dy, wt), 10),
           "dw_product": time_ms(torch, lambda: gmm._launch(xt, dy), 10)}
    del wt, xt
    return out


def check_gmm_grads(torch) -> dict:
    """Phase 8a's grouped-matmul backward: against autograd through the
    plain version at olmoe's prefill, a ragged C and both training shapes,
    both dtypes; bf16 reads x, w and dy in place (its only new memory is dx
    and dw), timed in turns with the copies path it replaced, that path by
    pass, and beside two ``torch.bmm``."""
    from repro_torch.kernels import grouped_matmul as gmm

    records = {}
    for what, E, C, d, f, seed in GMM_BWD_CASES:
        for dt in ("bfloat16", "float32"):
            (x, w), _, _ = gmm_case(torch, E, C, d, f, dt, seed=seed)
            dy = torch.randn(E, C, f, generator=torch.Generator(device=DEVICE).manual_seed(C),
                             device=DEVICE).to(x.dtype)
            route = gmm.backward_route(x)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            got = gmm.grouped_matmul_backward(x, w, dy)
            torch.cuda.synchronize()
            extra = torch.cuda.max_memory_allocated() - base
            outs = sum(g.numel() * g.element_size() for g in got)
            want = gmm.grouped_matmul_backward_plain(x, w, dy)
            res = [within(torch, a, b, GMM_BWD_TOL[dt],
                          scale=max(1.0, b.float().square().mean().sqrt().item()))
                   for a, b in zip(got, want)]
            print(f"grouped_matmul backward {what} ({E},{C},{d})x({E},{d},{f}) {dt}: route "
                  f"{route}, max_abs_err dx {res[0][0]:.3g} dw {res[1][0]:.3g}, within: "
                  f"{all(ok for _, ok in res)}; memory the call allocated {extra} bytes, dx and "
                  f"dw {outs}")
            check(all(ok for _, ok in res), f"grouped_matmul backward {what} {dt} disagrees "
                                            f"with its plain version: {res}")
            if route == "in_place":
                views = gmm.backward_views(x, w, dy)
                shared = [a.data_ptr() == b.data_ptr() for a, b in
                          ((views[0][1], w), (views[1][0], x), (views[0][0], dy))]
                check(all(shared) and extra <= outs,
                      f"grouped_matmul backward {what}: the in-place route copied an operand "
                      f"(views share storage: {shared}; allocated {extra} bytes beyond x, w, dy "
                      f"for {outs} bytes of dx and dw)")
            if dt == "bfloat16" and what != "ragged":
                wt = w.transpose(1, 2)
                new = lambda: gmm.grouped_matmul_backward(x, w, dy)
                old = lambda: gmm.grouped_matmul_backward(x, w, dy, route="copies")
                turns = [time_ms(torch, fn, 10) for fn in (old, new, new, old)]
                rec = dict(
                    max_abs_err=max(r[0] for r in res),
                    ms=(turns[1] + turns[2]) / 2,
                    plain_ms=time_ms(torch, lambda: gmm.grouped_matmul_backward_plain(x, w, dy),
                                     5),
                    library_ms=time_ms(torch, lambda: (torch.bmm(dy, wt),
                                                       torch.bmm(x.transpose(1, 2), dy)), 10),
                    shape=f"dx, dw of (E={E},C={C},d={d})x(E,d,f={f}) bfloat16, route {route}",
                    library="torch.bmm x2",
                    previous={"route": "copies", "ms": (turns[0] + turns[3]) / 2,
                              "turns_ms": turns,
                              "by_pass_ms": gmm_bwd_copies_by_pass(torch, x, w, dy)},
                    passes_ms=passes_ms(torch, new, GMM_BWD_PASSES, (turns[1] + turns[2]) / 2),
                )
                rec["bound_ms"], rec["bound_by"] = bound(
                    2 * (2 * E * C * d + E * d * f + E * C * f + E * d * f),
                    2 * 2 * E * C * d * f, "bfloat16")
                print(f"grouped_matmul backward {what} bf16: in place {rec['ms']:.4f} ms, copies "
                      f"{rec['previous']['ms']:.4f} (turns {[f'{t:.4f}' for t in turns]}; by pass "
                      f"{rec['previous']['by_pass_ms']}), two torch.bmm {rec['library_ms']:.4f}, "
                      f"bound {rec['bound_ms']:.4f} ({rec['bound_by']}); device ms by product "
                      f"{rec['passes_ms']}")
                # the training gate shape is the main path's; the others as sub-records
                key = "grouped_matmul_backward" + ("" if what == "train_gate" else f"_{what}")
                records[key] = rec
            del x, w, dy, got, want
        release(torch)
    return records


def check_kernel_grads(torch) -> dict:
    """Phase 8a: the flash backward, the grouped-matmul backward and the
    mLSTM and SSD backward kernels against their plain versions on the
    card, timed beside bound, plain and the PyTorch yardstick; the decode
    kernels, which have no backward, raise under grad."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ops

    print(f"flash backward tolerance: max |kernel - plain| <= tol x rms(plain), tol "
          f"{GRAD_TOL} (the forward's: max |kernel - plain| <= {TOL}); a backward that "
          f"skips one tile must read above it")
    records = {}
    for i, (what, B, H, Hkv, S, Skv, d, causal, window) in enumerate(FLASH_BWD_CASES):
        for dt in ("bfloat16", "float32"):
            xs, lse, got, want = flash_grads(torch, B, H, Hkv, S, Skv, d, dt, causal, window,
                                             seed=500 + i)
            errs = grad_errs(torch, got, want)
            q, k, v, o, do = xs
            lse_err = max_err(torch, lse, fa.flash_attention_heads_lse_plain(
                q, k, v, causal=causal, window=window))
            wrong = grad_errs(torch, skipped_tile_grads(torch, q, k, v, do, want, causal, window),
                              want)
            ok = max(errs) <= GRAD_TOL[dt] < min(wrong)
            route = "tensor cores (mma.sync)" if dt == "bfloat16" else "CUDA cores"
            print(f"flash_attention_backward {what} B={B} H={H} Hkv={Hkv} S={S} Skv={Skv} "
                  f"d={d} causal={causal} window={window} {dt} ({route}): max err / rms dq, dk, "
                  f"dv {[f'{e:.3g}' for e in errs]}; one tile skipped "
                  f"{[f'{e:.3g}' for e in wrong]}; limit {GRAD_TOL[dt]} between them: {ok}; "
                  f"forward lse max err {lse_err:.3g} (limit {LSE_ATOL})")
            check(lse_err <= LSE_ATOL, f"flash_attention {what} {dt}: the saved lse disagrees "
                                       f"with the plain one: {lse_err}")
            check(max(errs) <= GRAD_TOL[dt], f"flash_attention_backward {what} {dt} disagrees "
                                             f"with its plain version: {errs}")
            check(GRAD_TOL[dt] < min(wrong), f"flash_attention_backward {what} {dt}: the limit "
                                             f"would pass a skipped tile: {wrong}")
            again = fa.flash_attention_heads_backward(*xs, causal=causal, window=window, lse=lse)
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"flash_attention_backward {what} {dt}: a second call differs")
            if dt == "float32" and what != "internlm2":
                continue
            pairs = B * H * (window_pairs(S, window) if causal else S * Skv)
            flops = 10 * d * pairs   # five 2d-deep products a pair, given the forward's lse
            nbytes = q.element_size() * (4 * q.numel() + 4 * k.numel())
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            mask = None
            if window:
                mask = torch.ones(S, Skv, dtype=torch.bool, device=DEVICE).tril().triu(1 - window)
            ref_out = F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
            key = "flash_attention_backward" + ("" if what == "internlm2" else f"_{what}") + (
                "_f32" if dt == "float32" else "")
            reps = 3 if B * H * S * Skv > 1e8 and dt == "float32" else 10
            rec = dict(
                max_abs_err=max(max_err(torch, a, b) for a, b in zip(got, want)),
                ms=time_ms(torch, lambda: fa.flash_attention_heads_backward(
                    q, k, v, o, do, causal=causal, window=window, lse=lse), reps),
                plain_ms=time_ms(torch, lambda: fa.flash_attention_heads_backward_plain(
                    q, k, v, o, do, causal=causal, window=window), 3),
                library_ms=time_ms(torch, lambda: torch.autograd.grad(
                    ref_out, leaves, do, retain_graph=True), reps),
                shape=f"B={B} H={H} Hkv={Hkv} S={S} Skv={Skv} d={d} {dt} causal={causal} "
                      f"window={window}, given the forward's lse; {route}",
                library="sdpa backward (autograd.grad of scaled_dot_product_attention)",
            )
            rec["bound_ms"], rec["bound_by"] = bound(nbytes, flops, dt)
            if dt == "bfloat16":
                rec["passes_ms"] = passes_ms(torch, lambda: fa.flash_attention_heads_backward(
                    q, k, v, o, do, causal=causal, window=window, lse=lse), FLASH_BWD_PASSES,
                    rec["ms"])
            records[key] = rec
            print(f"flash_attention_backward {what} {dt}: {rec['ms']:.4f} ms given the lse, bound "
                  f"{rec['bound_ms']:.4f} ({rec['bound_by']}, 10 d flops a pair), plain "
                  f"{rec['plain_ms']:.4f}, sdpa backward {rec['library_ms']:.4f}; device ms by "
                  f"kernel {rec.get('passes_ms')}")
            del ref_out, leaves
        release(torch)
    records["flash_attention_lse"] = {"shape": "phase 3's flash shapes, bfloat16",
                                      "lse_cost": flash_lse_cost(torch)}

    print(f"grouped_matmul backward |kernel - plain| <= atol max(1, rms(plain)) + rtol |plain|, "
          f"(atol, rtol) = {GMM_BWD_TOL}")
    records.update(check_gmm_grads(torch))

    records.update(check_scan_grads(torch))

    # the kernels without a backward raise under grad, before launching
    before = read_counts()
    g = torch.Generator(device=DEVICE).manual_seed(7)
    mk = lambda *shape, dt=torch.bfloat16: torch.randn(
        *shape, generator=g, device=DEVICE).to(dt).requires_grad_(True)
    lens = torch.tensor([5, 16], dtype=torch.int32, device=DEVICE)
    kv8 = torch.zeros(2, 16, 2, 64, dtype=torch.int8, device=DEVICE)
    raising = {
        "decode_attention": lambda: ops.decode_attention_bhsd(
            mk(2, 1, 8, 64), mk(2, 16, 2, 64), mk(2, 16, 2, 64), lens),
        "decode_attention_q8": lambda: ops.decode_attention_q8_bhsd(
            mk(2, 1, 8, 64), kv8, kv8, mk(2, 16, 2, 1, dt=torch.float32),
            mk(2, 16, 2, 1, dt=torch.float32), lens),
    }
    for name, call in raising.items():
        try:
            call()
        except NotImplementedError as e:
            print(f"{name} under grad on the card raises: {e}")
        else:
            check(False, f"{name} under grad on the card did not raise")
    check(read_counts() == before, "a kernel without a backward launched under grad")
    return records


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{prefix}/{i}")
    else:
        yield prefix, tree


def card_vs_cpu(torch, arch: str, steps: int, layers: int = 2) -> dict:
    """``arch`` at full width, ``layers`` layers, B 1 x S 128, from one set of params:
    step 1's float32 gradients on the card against the CPU's; then, when
    ``steps``, that many trainer steps at WITNESS_OPT on both (float32) and
    in the published numerics (bf16 compute, full remat) on the card, the
    per-step losses compared with the float32 CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import as_tensors, batch_for_model
    from repro_torch.models.api import tree_map
    from repro_torch.optim import adamw
    from repro_torch.train.loop import Trainer
    from repro_torch.train.step import value_and_grad

    published = dataclasses.replace(get_config(arch), num_layers=layers)
    cfg = dataclasses.replace(published, param_dtype="float32", dtype="float32", remat="none")
    opt = adamw.AdamWConfig(**WITNESS_OPT)
    kw = dict(global_batch=1, seq_len=128, data_seed=3)
    card = Trainer(cfg, opt, device=DEVICE, **kw)
    card.init(1)
    cpu = Trainer(cfg, opt, device="cpu", **kw)
    cpu.params = tree_map(lambda t: t.detach().to("cpu", copy=True), card.params)
    cpu.opt_state = adamw.init(cpu.params)
    batch = batch_for_model(card.data, cfg, 0)
    loss_g, _, g_gpu = value_and_grad(card.model, card.params, as_tensors(batch, DEVICE))
    loss_c, _, g_cpu = value_and_grad(cpu.model, cpu.params, as_tensors(batch, "cpu"))
    worst, worst_leaf = 0.0, ""
    for (name, a), (_, b) in zip(named_leaves(g_gpu), named_leaves(g_cpu)):
        rel = max_err(torch, a.cpu(), b) / max(b.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_leaf = rel, name
    del g_gpu, g_cpu
    out = {"loss_card": loss_g.item(), "loss_cpu": loss_c.item(), "worst_leaf_rel_err": worst,
           "worst_leaf": worst_leaf, "tolerance": CARD_CPU_GRAD_RTOL}
    print(f"train {arch} gradients card vs CPU ({layers} layers, float32, B 1 x S 128): loss "
          f"{out['loss_card']:.6f} / {out['loss_cpu']:.6f}, worst leaf {worst_leaf} "
          f"max |card - CPU| / max |CPU| = {worst:.3g} (tolerance {CARD_CPU_GRAD_RTOL})")
    check(abs(out["loss_card"] - out["loss_cpu"]) <= 1e-4 * abs(out["loss_cpu"]),
          f"train {arch}: card and CPU losses differ: {out}")
    check(worst <= CARD_CPU_GRAD_RTOL, f"train {arch}: card and CPU gradients differ: {out}")
    if not steps:
        return out
    # the published numerics from the same params, before either float32
    # trainer steps (the optimizer updates params in place)
    pub = Trainer(published, opt, device=DEVICE, **kw)
    pub.params = tree_map(lambda t: t.detach().clone(), card.params)
    pub.opt_state = adamw.init(pub.params)
    losses = {"bfloat16_card": [pub.run_steps(1)["loss"] for _ in range(steps)]}
    del pub
    release(torch)
    losses["float32_card"] = [card.run_steps(1)["loss"] for _ in range(steps)]
    losses["float32_cpu"] = [cpu.run_steps(1)["loss"] for _ in range(steps)]
    ref = losses["float32_cpu"]
    dev = {run: max(abs(x - y) / abs(y) for x, y in zip(losses[run], ref))
           for run in ("float32_card", "bfloat16_card")}
    out.update(witness_opt=WITNESS_OPT, witness_losses=losses, witness_rel_dev=dev,
               witness_tolerance=WITNESS_RTOL)
    print(f"train {arch} at AdamW {WITNESS_OPT}, {steps} steps from the same params "
          f"({layers} layers, B 1 x S 128): losses {({k: [round(x, 4) for x in v] for k, v in losses.items()})}; "
          f"largest relative deviation from the float32 CPU run {dev} (limits float32 "
          f"{WITNESS_RTOL['float32']}, bf16 {WITNESS_RTOL['bfloat16']})")
    check(dev["float32_card"] <= WITNESS_RTOL["float32"],
          f"train {arch}: card and CPU trainers part at lr {WITNESS_OPT['lr']}: {losses}")
    check(dev["bfloat16_card"] <= WITNESS_RTOL["bfloat16"],
          f"train {arch}: the bf16 card trainer parts from the float32 CPU's: {losses}")
    return out


def train_launches(cfg, steps: int) -> tuple[dict, str]:
    """The kernel launches ``steps`` trainer steps of ``cfg`` make, and the
    rule they follow.  Under remat (``transformer.remat``) a layer's
    forward runs twice, once in the forward pass and again before its
    backward, and its backward once: so every kernel of a rematerialised
    layer launches its forward twice a step and its backward once; with
    ``remat="none"`` once each.  zamba2's shared attention block is applied
    outside remat (``zamba2.py:81`` rematerialises only the Mamba2 blocks):
    its flash forward and backward launch once an application."""
    L = cfg.num_layers
    fwd = 1 if cfg.remat == "none" else 2
    how = "without remat: its forward once a step" if fwd == 1 else \
        "each rematerialised: its forward twice a step"
    if cfg.family == "ssm":   # xLSTM: the sLSTM layers run plain ops
        from repro_torch.models.xlstm import _group_counts
        G, M, _ = _group_counts(cfg)
        return ({"mlstm": fwd * G * M * steps, "mlstm_backward": G * M * steps},
                f"{G * M} mLSTM layers, {how}, its backward once; the sLSTM layers launch "
                f"none")
    if cfg.family == "hybrid":   # zamba2
        apps = L // cfg.ssm.attn_every
        return ({"mamba2_ssd": fwd * L * steps, "mamba2_ssd_backward": L * steps,
                 "flash_attention": apps * steps, "flash_attention_backward": apps * steps},
                f"{L} Mamba2 blocks, {how}, its backward once; {apps} application(s) of the "
                f"shared attention outside remat: flash forward and backward once each")
    return ({"flash_attention": fwd * L * steps, "flash_attention_backward": L * steps,
             "grouped_matmul": 3 * fwd * L * steps if cfg.moe else 0,
             "grouped_matmul_backward": 3 * L * steps if cfg.moe else 0},
            f"{L} attention layers, {how}, flash backward once; 3 grouped-matmul forwards a "
            f"MoE layer each pass and one backward launch each (bf16: dx and dw in one call)")


def train_full(torch, arch: str, layers: int, steps: int) -> dict:
    """Phase 8b/8c: ``arch`` at full width cut to ``layers`` layers, as the
    config publishes it (float32 params, bf16 compute, full remat), trained
    through ``Trainer.register_handlers`` and ``train/run_steps`` on a local
    ``OffloadDomain``: every gradient leaf of step 1 finite and non-zero,
    the loss falling, exact launch counts, step times and a profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.core.closure import f2f
    from repro_torch.core.registry import HandlerRegistry
    from repro_torch.data.pipeline import as_tensors, batch_for_model
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.counting import count_params, model_flops
    from repro_torch.offload.api import OffloadDomain
    from repro_torch.offload.runtime import register_internal_handlers
    from repro_torch.optim import adamw
    from repro_torch.train.loop import Trainer
    from repro_torch.train.step import value_and_grad

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    check(cfg.remat == "full" and cfg.dtype == "bfloat16" and cfg.param_dtype == "float32",
          f"{arch}: not the published numerics")
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, adamw.AdamWConfig(**TRAIN_OPT), global_batch=TRAIN_BATCH,
                 seq_len=TRAIN_SEQ, device=DEVICE)
    reg = HandlerRegistry()
    register_internal_handlers(reg)
    tr.register_handlers(reg)
    reg.init()
    tr.init(0)
    # step 1's gradients, taken apart from the run: a gradient that stopped
    # at a kernel would be zero (or the leaf would get none)
    batch = as_tensors(batch_for_model(tr.data, cfg, 0), DEVICE)
    _, _, grads = value_and_grad(tr.model, tr.params, batch)
    leaves = list(named_leaves(grads))
    bad = [n for n, g in leaves if not bool(torch.isfinite(g).all()) or g.abs().max().item() == 0]
    print(f"train {arch}: step-1 gradients of {len(leaves)} leaves, all finite and non-zero: "
          f"{not bad}")
    check(not bad, f"train {arch}: gradient leaves zero or not finite: {bad}")
    del grads, leaves, batch
    release(torch)

    times = []
    step_fn = tr.step_fn

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    tr.step_fn = timed_step
    dom = OffloadDomain.local(2, registry=reg)
    try:
        zero_counts()
        last = dom.sync(1, f2f("train/run_steps", steps, registry=reg), timeout=900)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        prof = profile_window(torch, lambda: dom.sync(
            1, f2f("train/run_steps", 1, registry=reg), timeout=900), 1, windows=2)
    finally:
        dom.shutdown()
    check(last["step"] == steps, f"train {arch}: ran {last['step']} of {steps} steps")
    losses = [h["loss"] for h in tr.metrics_history[:steps]]
    want, rule = train_launches(cfg, steps)
    print(f"train {arch} ({layers} layers, B {TRAIN_BATCH} x S {TRAIN_SEQ}, {steps} steps "
          f"through train/run_steps, AdamW {TRAIN_OPT}): losses "
          f"{[round(x, 4) for x in losses]}; launches {counts}, expected {want} ({rule})")
    check(losses[-1] < losses[0], f"train {arch}: the loss did not fall: {losses}")
    for name, n in counts.items():
        check(n == want.get(name, 0), f"train {arch}: {name} launched {n} times, not "
                                      f"{want.get(name, 0)}")
    times_ms = sorted(1e3 * t for t in times[:steps])
    p50, p90 = times_ms[len(times_ms) // 2], times_ms[int(0.9 * (len(times_ms) - 1))]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = model_flops(cfg, ShapeCell("train", "train", TRAIN_SEQ, TRAIN_BATCH))
    stats = {
        "arch": arch, "layers": layers, "params": count_params(cfg), "steps": steps,
        "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "adamw": TRAIN_OPT, "losses": losses,
        "aux_last": tr.metrics_history[steps - 1].get("aux"),
        "step_ms_p50": p50, "step_ms_p90": p90, "step_samples": len(times_ms),
        "tokens_per_s": tokens / (p50 / 1e3),
        "model_flops_per_step": flops,
        "model_flops_share_of_bf16_peak": flops / (p50 / 1e3) / PEAK_FLOPS["bfloat16"],
        "max_memory_allocated_gb": peak / 1e9, "launches": counts, "profile": prof,
    }
    print(f"train {arch}: step p50 {p50:.1f} ms (p90 {p90:.1f}, {len(times_ms)} steps), "
          f"{stats['tokens_per_s']:.0f} tokens/s, model FLOPs {flops:.3g} a step = "
          f"{stats['model_flops_share_of_bf16_peak']:.3f} of the bf16 peak, peak memory "
          f"{stats['max_memory_allocated_gb']:.1f} GB; profiled step: wall "
          f"{prof['wall_ms_per_call']:.1f} ms, busy {prof['device_busy_ms_per_call']:.1f} ms, "
          f"idle {prof['device_idle_share']:.3f}")
    return stats


def checkpoint_restart(torch) -> dict:
    """Phase 8d: a narrow internlm2-shaped config (head_dim 64) trained 6
    steps and checkpointed; a second trainer restores it, and both run 3
    more steps, whose losses must agree within 1e-6 (tests/test_train.py's
    bound)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.optim import adamw
    from repro_torch.train.loop import Trainer

    cfg = dataclasses.replace(get_config("internlm2-20b"), **RESTART)
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    kw = dict(ckpt_dir=str(ckpt), ckpt_every=4, global_batch=4, seq_len=512, device=DEVICE)
    try:
        a = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), **kw)
        a.init(0)
        a.run_steps(6)
        a.checkpoint(blocking=True)
        b = Trainer(cfg, adamw.AdamWConfig(lr=1e-3), **kw)
        check(b.maybe_restore() and b.step == a.step == 6, "checkpoint restart: no restore")
        check(all(p.device.type == torch.device(DEVICE).type
                  for p in (b.params["embed"]["table"], b.opt_state["step"])),
              "checkpoint restart: restored tensors are not on the card")
        la = [a.run_steps(1)["loss"] for _ in range(3)]
        lb = [b.run_steps(1)["loss"] for _ in range(3)]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    diff = max(abs(x - y) for x, y in zip(la, lb))
    print(f"checkpoint restart (internlm2-shaped, d {cfg.d_model}, head_dim "
          f"{cfg.resolved_head_dim}, 2 layers): losses after restore {lb}, uninterrupted {la}, "
          f"max difference {diff:.3g} (bound 1e-6)")
    check(diff <= 1e-6, f"checkpoint restart: losses differ by {diff}")
    return {"losses_uninterrupted": la, "losses_restored": lb, "max_diff": diff}


# -- phase 7: process fabrics (host code on the card's machine) ---------------

# the reference's own non-smoke sizes: benchmarks/offload_overhead.py (Fig. 3
# analogue) and benchmarks/cluster.py's data-plane section
FIG3 = {"calls": 2000, "warmup": 200}
FIG3_LEGS = ("local", "shm_fork", "shm_fresh", "socket_fresh")
CHAIN = {"workers": 4, "buffers": 8, "elems": 128 << 10, "replicas": (0, 1, 2)}
MUTATE = {"nbytes": (1 << 20, 8 << 20), "iters": 5}
FRESH_ADD_NBYTES = 8 << 20  # each float32 CUDA operand of phase 7b's demo/add
FRESH_RING = 1 << 26  # shm ring for 7b: a 16 MiB request frame must fit


def fabric_registry():
    """The host's handler table for phase 7: the runtime's internal and
    data-plane handlers, the cluster pool's and the demo handlers, sealed in
    the default registry that forked workers inherit and fresh interpreters
    re-derive from the same imports."""
    import repro_torch.cluster.pool  # noqa: F401  (_cluster/*, _ham/buf_*)
    import repro_torch.offload.demo_handlers  # noqa: F401  (demo/*, chaos/*)
    from repro_torch.core.registry import default_registry

    reg = default_registry()
    if not reg.initialised:
        reg.init()
    return reg


def median_us(fn, n: int, warmup: int) -> float:
    """Median host time of one call of ``fn`` over ``n`` calls, after
    ``warmup`` calls (microseconds)."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return 1e6 * ts[n // 2]


def start_worker(leg: str, reg, ring: int = 1 << 24):
    """One worker on node 1 for ``leg`` (shm_fork, shm_fresh, socket_fresh)
    and the host's domain over its fabric; returns (domain, procs, fabric).
    The worker has passed the digest ping when this returns."""
    from repro_torch.comm.shm import ShmFabric
    from repro_torch.comm.socket import SocketFabric
    from repro_torch.core.closure import f2f
    from repro_torch.core.registry import verify_peer_digest
    from repro_torch.offload import worker
    from repro_torch.offload.api import OffloadDomain

    mods = worker.registered_setup_modules(reg)
    if leg == "socket_fresh":
        fab = SocketFabric(2)
        fab.endpoint(0)
        procs = [worker.spawn_socket_worker_subprocess(1, 2, fab.base_port, mods)]
    else:
        fab = ShmFabric(2, capacity=ring)
        procs = (worker.spawn_shm_workers(fab, [1], mods) if leg == "shm_fork"
                 else [worker.spawn_shm_worker_subprocess(fab, 1, mods)])
    dom = OffloadDomain(fab, registry=reg, inline_host=True)
    try:
        check(dom.ping(1, 7, timeout=60.0) == 7, f"{leg}: the worker did not answer")
        digest = dom.sync(1, f2f("_cluster/digest", registry=reg), 30.0)
        verify_peer_digest(reg.table, bytes.fromhex(digest))
    except BaseException:
        stop_worker(dom, procs, fab, exempt=procs)
        raise
    return dom, procs, fab


def stop_worker(dom, procs, fab, exempt=()) -> None:
    """Shut the domain down, reap the workers and close the fabric; every
    worker not in ``exempt`` (one killed on purpose) must have left on the
    shutdown message with exit code 0, not by ``reap``'s terminate or kill."""
    from repro_torch.offload.worker import reap

    try:
        dom.shutdown()
        reap(procs, timeout=5.0)
    finally:
        fab.close()
    for p in procs:
        if any(p is q for q in exempt):
            continue
        code = p.exitcode if hasattr(p, "exitcode") else p.returncode
        check(code == 0, f"a worker did not shut down cleanly (exit code {code})")


def fig3_legs(reg) -> dict:
    """Median round trip of ``demo/empty`` (dynamic payload) and
    ``demo/empty_static`` (compiled plan) on each leg, microseconds."""
    from repro_torch.core.closure import f2f
    from repro_torch.offload.api import OffloadDomain

    out = {}
    for leg in FIG3_LEGS:
        if leg == "local":
            dom, procs, fab = OffloadDomain.local(2, registry=reg), [], None
        else:
            dom, procs, fab = start_worker(leg, reg)
        try:
            out[leg] = {}
            for name in ("demo/empty", "demo/empty_static"):
                call = f2f(name, registry=reg)
                check(dom.sync(1, call, 30.0) is None, f"{leg}: {name} returned a value")
                out[leg][name.split("/")[1] + "_us"] = median_us(
                    lambda: dom.sync(1, call, 30.0), FIG3["calls"], FIG3["warmup"])
        finally:
            if fab is None:
                dom.shutdown()
            else:
                stop_worker(dom, procs, fab)
    return out


def wait_for(cond, what: str, timeout: float = 20.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        check(time.monotonic() < deadline, f"timed out waiting for {what}")
        time.sleep(0.02)


def holders_equal(pool, ptr, payload) -> list[int]:
    """Every holder of ``ptr`` returns ``payload``'s bytes; returns them."""
    rec = pool.directory.lookup(ptr.handle)
    holders = [rec.primary, *rec.replicas]
    for h in holders:
        got = pool.domain.get(ptr.at(h, rec.epoch))
        check(got.dtype == payload.dtype and got.tobytes() == payload.tobytes(),
              f"holder {h} of buffer {ptr.handle} returned other bytes")
    return holders


def chain_put_and_failure(reg) -> dict:
    """Chain-replicated puts on ``ClusterPool.shm(4, replicas=R)``: eight
    1 MiB float64 buffers, a warm put and a timed put each, and the host
    pushing the same bytes to every holder itself; each holder returns the
    bytes after every put.  On R = 1, the worker holding the first buffer's
    primary is killed: its replica is promoted and every buffer reads back."""
    from repro_torch.cluster import ClusterPool

    rng = np.random.default_rng(7)
    out: dict = {}
    for r in CHAIN["replicas"]:
        pool = ClusterPool.shm(CHAIN["workers"], registry=reg, replicas=r)
        try:
            pool.ping_all(timeout=60.0)
            ptrs = [pool.allocate((CHAIN["elems"],), "float64", session=f"c{r}-{i}")
                    for i in range(CHAIN["buffers"])]
            chain_ts, seq_ts, payloads = [], [], []
            for ptr in ptrs:
                warm = rng.standard_normal(CHAIN["elems"])
                pool.put(warm, ptr)
                check(len(holders_equal(pool, ptr, warm)) == r + 1,
                      f"replicas={r}: a buffer has another holder count")
                payload = rng.standard_normal(CHAIN["elems"])
                t0 = time.perf_counter()
                pool.put(payload, ptr)
                chain_ts.append(time.perf_counter() - t0)
                holders = holders_equal(pool, ptr, payload)
                t0 = time.perf_counter()
                for h in holders:
                    pool.domain.put(payload, ptr.at(h))
                seq_ts.append(time.perf_counter() - t0)
                holders_equal(pool, ptr, payload)
                payloads.append(payload)
            out[f"replicas{r}"] = {"put_ms": 1e3 * float(np.median(chain_ts)),
                                   "host_sequential_ms": 1e3 * float(np.median(seq_ts))}
            if r == 1:
                victim = pool.directory.lookup(ptrs[0].handle).primary
                t0 = time.perf_counter()
                pool.kill(victim)
                wait_for(lambda: pool.directory.lookup(ptrs[0].handle).primary != victim,
                         "the replica's promotion")
                promoted_s = time.perf_counter() - t0
                check(pool.directory.stats["lost"] == 0, "a buffer was lost with its primary")
                for ptr, payload in zip(ptrs, payloads):
                    got = pool.get(ptr)
                    check(got.tobytes() == payload.tobytes(),
                          "a buffer read back other bytes after its primary died")
                out["failure"] = {"killed": victim, "promoted_ms": 1e3 * promoted_s,
                                  "buffers_intact": len(ptrs)}
        finally:
            pool.close()
    return out


def mutate_at_data(reg) -> dict:
    """``pool.mutate(demo/saxpy)`` at the primary against get-mutate-put on
    ``ClusterPool.shm(2, replicas=1)``, 1 MiB and 8 MiB float64 buffers; the
    buffer ends equal to numpy's saxpy, applied as often, bit for bit."""
    from repro_torch.cluster import ClusterPool
    from repro_torch.core.closure import f2f

    alpha, rng, out = 0.5, np.random.default_rng(11), {}
    pool = ClusterPool.shm(2, registry=reg, replicas=1)
    try:
        pool.ping_all(timeout=60.0)
        home = pool.worker_nodes[0]
        for nbytes in MUTATE["nbytes"]:
            n = nbytes // 8
            x0, y0 = rng.standard_normal(n), rng.standard_normal(n)
            x = pool.allocate((n,), "float64", node=home, session=f"m-{nbytes}")
            y = pool.allocate((n,), "float64", node=home, session=f"m-{nbytes}")
            pool.put(x0, x)
            pool.put(y0, y)
            want = y0.copy()
            fn = f2f("demo/saxpy", alpha, x, y, registry=reg)
            mut_ts, naive_ts = [], []
            for _ in range(1 + MUTATE["iters"]):  # the first is the warm-up
                t0 = time.perf_counter()
                pool.mutate(fn)
                mut_ts.append(time.perf_counter() - t0)
                want += alpha * x0
            check(pool.get(y).tobytes() == want.tobytes(), "mutate-at-data != numpy saxpy")
            xs = np.array(pool.get(x))
            for _ in range(MUTATE["iters"]):
                t0 = time.perf_counter()
                ys = np.array(pool.get(y))  # shm get is a read-only view
                ys += alpha * xs
                pool.put(ys, y)
                naive_ts.append(time.perf_counter() - t0)
                want += alpha * x0
            check(pool.get(y).tobytes() == want.tobytes(), "get-mutate-put != numpy saxpy")
            out[str(nbytes)] = {"mutate_ms": 1e3 * float(np.median(mut_ts[1:])),
                                "get_mutate_put_ms": 1e3 * float(np.median(naive_ts))}
    finally:
        pool.close()
    return out


def process_fabrics_forked() -> dict:
    """Phase 7a, before any CUDA context exists in this process: the Fig. 3
    legs, chain put with the failure leg, and mutate-at-data."""
    import os
    import platform
    import shutil

    from repro_torch.comm.doorbell import futex_available

    reg = fabric_registry()
    t0 = time.perf_counter()
    out = {"machine": platform.machine(), "cpu_count": os.cpu_count(),
           "futex": futex_available(),
           "dev_shm_bytes": shutil.disk_usage("/dev/shm").total,
           "fig3_median_us": fig3_legs(reg), "chain_put": chain_put_and_failure(reg),
           "mutate_at_data": mutate_at_data(reg)}
    out["forked_s"] = time.perf_counter() - t0
    return out


def process_fabrics_fresh(torch) -> dict:
    """Phase 7b, with CUDA up in this process (the case fresh interpreters
    exist for): an shm and a socket fresh-interpreter worker each pass the
    digest ping, add two 8 MiB float32 CUDA tensors (staged through pinned
    host memory) bit for bit as ``(a + b).cpu()``, and hold a CUDA tensor
    put into a buffer; the shm worker is then killed, respawned under the
    same id and called again."""
    from repro_torch.core.closure import f2f
    from repro_torch.offload.worker import registered_setup_modules, spawn_shm_worker_subprocess

    reg = fabric_registry()
    n = FRESH_ADD_NBYTES // 4
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    a = torch.randn(n, device=DEVICE, generator=gen)
    b = torch.randn(n, device=DEVICE, generator=gen)
    want = (a + b).cpu().numpy()
    a_host = a.cpu().numpy()

    def drive(dom, leg: str) -> dict:
        """Two adds and two puts: the first of each also pays for touching
        the transport's buffers (a fresh ring's pages) for the first time."""
        out = {}
        for i in range(2):
            t0 = time.perf_counter()
            got = dom.sync(1, f2f("demo/add", a, b, registry=reg), 60.0)
            out[f"add_8MiB_ms_{i}"] = 1e3 * (time.perf_counter() - t0)
            check(isinstance(got, np.ndarray) and got.dtype == np.float32
                  and got.tobytes() == want.tobytes(), f"{leg}: demo/add != (a + b).cpu()")
        ptr = dom.allocate(1, (n,), "float32")
        for i in range(2):
            t0 = time.perf_counter()
            dom.put(a, ptr)
            out[f"put_8MiB_ms_{i}"] = 1e3 * (time.perf_counter() - t0)
            back = dom.get(ptr)
            check(back.tobytes() == a_host.tobytes(),
                  f"{leg}: a put CUDA tensor read back other bytes")
        dom.free(ptr)
        return out

    out = {}
    for leg in ("socket_fresh", "shm_fresh"):
        t0 = time.perf_counter()
        dom, procs, fab = start_worker(leg, reg, ring=FRESH_RING)
        try:
            out[leg] = {"start_s": time.perf_counter() - t0, **drive(dom, leg)}
            if leg == "shm_fresh":
                procs[0].kill()
                procs[0].wait(10.0)
                time.sleep(0.5)  # the dead interpreter's resource tracker exits
                t0 = time.perf_counter()
                fab.prepare_restart(1)
                dom.host.endpoint.reset_peer(1)
                procs.append(spawn_shm_worker_subprocess(fab, 1, registered_setup_modules(reg)))
                check(dom.ping(1, 9, timeout=60.0) == 9, "the respawned shm worker did not answer")
                out[leg]["respawn_s"] = time.perf_counter() - t0
                out[leg]["after_respawn"] = drive(dom, leg + " respawned")
        finally:
            stop_worker(dom, procs, fab, exempt=procs[:1] if leg == "shm_fresh" else ())
    return out


# -- phase 9: sharding and launch: the models through a DeviceMesh ------------

# 9a: phase 8's internlm2-20b cell through a Trainer on a 1 x 1 mesh, its
# first SHARDED_STEPS losses held to the unsharded trainer's (phase 8's
# run, the same seed and data) within SHARDED_LOSS_RTOL relative
SHARDED_STEPS = 6
SHARDED_LOSS_RTOL = 1e-5
# 9b, 9c: (arch, layers or None for all, batch, prompt, decode steps)
SHARDED_DECODE = (("internlm2-20b", None, 2, 1024, 16), ("olmoe-1b-7b", None, 2, 512, 8))
# sharded logits against the unsharded model's: max |a - b| / max |b|
SHARDED_LOGIT_RTOL = 1e-3
# 9d: a step measured faster than this share of its roofline bound means
# the count is wrong
ROOFLINE_FLOOR = 0.95
# 9e: the production-mesh dry-runs in a fresh interpreter (fake process
# group): (arch, cell); llama3-405b's train_4k only if internlm2-20b's took
# less than DRYRUN_MORE_BELOW_S
DRYRUNS = (("internlm2-20b", "train_4k"), ("internlm2-20b", "decode_32k"))
DRYRUN_MORE = ("llama3-405b", "train_4k")
DRYRUN_MORE_BELOW_S = 120.0


def one_card_mesh(torch):
    """The 1 x 1 ("data", "model") mesh on the card, over a one-rank NCCL
    group of an in-memory store."""
    from repro_torch.launch.mesh import make_mesh, single_rank_world

    single_rank_world()
    return make_mesh((1, 1), ("data", "model"))


def leaves_are_dtensors(tree) -> bool:
    from repro_torch.core.dtensor import is_dtensor
    from repro_torch.optim.adamw import tree_leaves

    return all(is_dtensor(t) for t in tree_leaves(tree))


def sharded_train(torch, mesh, unsharded: dict) -> dict:
    """Phase 9a: internlm2-20b at phase 8's cell (2 layers, full width, B 4
    x S 2048, float32 params, bf16 compute, full remat) trained
    SHARDED_STEPS steps through ``Trainer(sharder=)`` on the 1 x 1 mesh:
    every param and moment a DTensor, the losses phase 8's within
    SHARDED_LOSS_RTOL, exact flash launches, step times beside phase 8's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.plans import plan_for
    from repro_torch.models.config import shape_cell
    from repro_torch.models.sharding import Sharder
    from repro_torch.optim import adamw
    from repro_torch.train.loop import Trainer

    arch = "internlm2-20b"
    cfg = dataclasses.replace(get_config(arch), num_layers=unsharded["layers"])
    sharder = Sharder(mesh, plan_for(arch, shape_cell("train_4k")))
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(cfg, adamw.AdamWConfig(**TRAIN_OPT), global_batch=TRAIN_BATCH,
                 seq_len=TRAIN_SEQ, sharder=sharder, device=DEVICE)
    tr.init(0)
    check(leaves_are_dtensors(tr.params) and leaves_are_dtensors(
        {"mu": tr.opt_state["mu"], "nu": tr.opt_state["nu"]}),
        "9a: a param or moment of the sharded trainer is no DTensor")
    times, step_fn = [], tr.step_fn

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step_fn(*args)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        return out

    tr.step_fn = timed_step
    zero_counts()
    tr.run_steps(SHARDED_STEPS)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in tr.metrics_history]
    want_losses = unsharded["losses"][:SHARDED_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    want, rule = train_launches(cfg, SHARDED_STEPS)
    ms = sorted(1e3 * t for t in times)
    out = {"arch": arch, "layers": cfg.num_layers, "mesh": "1x1 (data, model)",
           "plan": dataclasses.asdict(sharder.plan), "steps": SHARDED_STEPS,
           "losses": losses, "unsharded_losses": want_losses, "loss_rel_gap": rel,
           "step_ms_p50": ms[len(ms) // 2], "step_ms_all": ms,
           "unsharded_step_ms_p50": unsharded["step_ms_p50"],
           "max_memory_allocated_gb": peak / 1e9,
           "unsharded_max_memory_allocated_gb": unsharded["max_memory_allocated_gb"],
           "launches": counts}
    print(f"9a sharded train {arch} ({cfg.num_layers} layers, B {TRAIN_BATCH} x S {TRAIN_SEQ}, "
          f"1 x 1 mesh): losses {[round(x, 6) for x in losses]} against unsharded "
          f"{[round(x, 6) for x in want_losses]} (max rel gap {rel:.3g}); step p50 "
          f"{out['step_ms_p50']:.1f} ms (unsharded {unsharded['step_ms_p50']:.1f}); peak "
          f"{out['max_memory_allocated_gb']:.1f} GB; launches {counts}, expected {want} ({rule})")
    check(rel <= SHARDED_LOSS_RTOL, f"9a: sharded losses off the unsharded ones by {rel:.3g}")
    for name, n in counts.items():
        check(n == want.get(name, 0), f"9a: {name} launched {n} times, not {want.get(name, 0)}")
    return out


def sharded_decode(torch, mesh, arch, layers, B, prompt, steps) -> dict:
    """Phases 9b, 9c: ``arch`` in bf16 per ``tuned_config(arch,
    decode_32k)`` (``layers`` of them, None for all) under the serving plan
    on the 1 x 1 mesh: one ``prompt``-token prefill and ``steps`` greedy
    decode steps, sharded beside unsharded on the same params (the mesh
    wraps them, no copy) and tokens; logits within SHARDED_LOGIT_RTOL,
    greedy tokens identical, exact launches a step."""
    from repro_torch.launch.plans import plan_for, tuned_config
    from repro_torch.models.api import build_model
    from repro_torch.models.config import shape_cell
    from repro_torch.models.sharding import Sharder

    cell = shape_cell("decode_32k")
    cfg = tuned_config(arch, cell)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    m = build_model(cfg, device=DEVICE)
    params = m.init(0)
    sharder = Sharder(mesh, plan_for(arch, cell))
    dparams = sharder.distribute(params, m.param_rules())
    g = torch.Generator(device=DEVICE).manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (B, prompt), generator=g, device=DEVICE)
    gap = lambda a, b: ((a.full_tensor() if hasattr(a, "full_tensor") else a).float()
                        - b.float()).abs().max().item() / b.float().abs().max().item()
    out = {"arch": arch, "layers": cfg.num_layers, "batch": B, "prompt": prompt,
           "steps": steps, "param_dtype": cfg.param_dtype}
    with torch.no_grad():
        logits, cache = m.prefill(params, {"tokens": tok})
        zero_counts()
        slogits, _ = m.prefill(dparams, {"tokens": sharder.distribute(tok, ["batch", None])},
                               sharder=sharder)
        torch.cuda.synchronize()
        out["prefill_launches"] = read_counts()
        out["prefill_logit_gap"] = gap(slogits, logits)
        big = m.init_cache(B, prompt + steps)
        for name in big:
            big[name][:, :, :prompt] = cache[name]
        del cache, slogits
        dcache = sharder.distribute({n: t.clone() for n, t in big.items()}, m.cache_rules())
        out["cache_placements"] = [str(p) for p in dcache["k"].placements]
        nxt = logits[:, -1:].argmax(-1)
        gaps, same, t_u, t_s = [], True, [], []
        per_step = []
        for i in range(steps):
            batch = {"tokens": nxt, "pos": torch.tensor(prompt + i, device=DEVICE)}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, big = m.decode_step(params, big, batch)
            torch.cuda.synchronize()
            t_u.append(time.perf_counter() - t0)
            sbatch = {"tokens": sharder.distribute(nxt, ["batch", None]), "pos": batch["pos"]}
            zero_counts()
            t0 = time.perf_counter()
            slg, dcache = m.decode_step(dparams, dcache, sbatch, sharder=sharder)
            torch.cuda.synchronize()
            t_s.append(time.perf_counter() - t0)
            per_step.append(read_counts())
            gaps.append(gap(slg, lg))
            same &= bool((slg.full_tensor().argmax(-1) == lg.argmax(-1)).all())
            nxt = lg.argmax(-1)
    out.update(logit_gap=max(gaps + [out["prefill_logit_gap"]]), tokens_identical=same,
               step_launches=per_step[-1],
               decode_step_ms_p50=sorted(1e3 * t for t in t_s)[steps // 2],
               unsharded_decode_step_ms_p50=sorted(1e3 * t for t in t_u)[steps // 2])
    L = cfg.num_layers
    want = ({"decode_attention": L} if cfg.moe is None else
            {"decode_attention": L, "grouped_matmul": 3 * L})
    print(f"9b/9c sharded decode {arch} ({L} layers, {cfg.param_dtype}, B {B}, prompt {prompt}, "
          f"{steps} steps, cache {out['cache_placements']}): logit gap {out['logit_gap']:.3g}, "
          f"tokens identical {same}; step p50 {out['decode_step_ms_p50']:.1f} ms (unsharded "
          f"{out['unsharded_decode_step_ms_p50']:.1f}); launches a step {per_step[-1]}, "
          f"prefill {out['prefill_launches']}")
    check(out["logit_gap"] <= SHARDED_LOGIT_RTOL, f"{arch}: sharded logits off by "
                                                  f"{out['logit_gap']:.3g}")
    check(same, f"{arch}: sharded greedy tokens differ from the unsharded model's")
    for counts in per_step:
        for name, n in counts.items():
            check(n == want.get(name, 0), f"{arch}: {name} launched {n} times a step, not "
                                          f"{want.get(name, 0)}")
    check(out["prefill_launches"]["flash_attention"] == L, f"{arch}: prefill flash launches")
    out["launches"] = {k: out["prefill_launches"].get(k, 0) + sum(c.get(k, 0) for c in per_step)
                       for k in set(out["prefill_launches"]) | set(per_step[-1])}
    del params, dparams, big, dcache
    return out


ROOFLINE_CHILD = """
import json, sys, time
sys.path.insert(0, {src!r})
import dataclasses
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, plans
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.op_analysis import analyze, matmul_flops
from repro_torch.launch.roofline import analytic_memory_bytes, build_report, tree_shard_bytes
from repro_torch.models.api import build_model
from repro_torch.models.config import ShapeCell, shape_cell
from repro_torch.models.counting import model_flops
from repro_torch.models.sharding import Sharder

fake_world(1)
mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
out = {{}}
for key, arch, layers, cell, plan_cell, dtype in {cases!r}:
    t0 = time.perf_counter()
    cell = ShapeCell(*cell)
    base = (get_config(arch) if dtype == "published"
            else plans.tuned_config(arch, shape_cell(plan_cell)))
    cfg = dataclasses.replace(base, num_layers=layers or base.num_layers)
    plan = plans.plan_for(arch, shape_cell(plan_cell))
    sharder = Sharder(mesh, plan)
    model = build_model(cfg, device="meta")
    args, _ = dryrun.shardings_for(model, sharder, cell, "float32")
    step = dryrun.step_for(model, sharder, cell, "float32")
    _, cost = analyze(step, *args)
    param_b = tree_shard_bytes(args[0])
    opt_b = tree_shard_bytes(args[1]) if cell.kind == "train" else 0
    cache_b = tree_shard_bytes(args[1]) if cell.kind == "decode" else 0
    analytic = analytic_memory_bytes(cfg, cell, mesh, plan, param_bytes=param_b,
                                     opt_bytes=opt_b, cache_bytes=cache_b)
    r = build_report(arch, cell.name, "1x1", 1, cost, model_flops(cfg, cell), {{}},
                     analytic_bytes=analytic)
    out[key] = dict(r.to_dict(), matmul_flops=matmul_flops(cost), seconds=time.perf_counter() - t0,
                    loops=cost.loops, summary=r.summary())
print(json.dumps(out))
"""


def start_child(args):
    """A fresh interpreter (its own process group: the dry-runs' fake
    ones), started now and read by :func:`finish_child`; host work only, it
    runs beside the card phases."""
    import atexit
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.Popen([sys.executable, *args], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
    atexit.register(proc.kill)   # a phase that fails before reading it leaves none behind
    return proc, args, time.perf_counter()


def finish_child(child, timeout: float, expect: int = 0) -> tuple[str, float]:
    """The child's stdout and its seconds from start to exit; its exit code
    must be ``expect``."""
    proc, args, t0 = child
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    finally:
        proc.kill()
    check(proc.returncode == expect, f"{args[:4]} exited with code {proc.returncode}, not "
                                     f"{expect}: {stdout[-2000:]}\n{stderr[-2000:]}")
    return stdout, time.perf_counter() - t0


def roofline_cases(train_layers: int) -> list:
    """(key, arch, layers, cell, plan cell, numerics) of 9d: 9a's train step
    (the published numerics) and 9b's decode step (``tuned_config``)."""
    arch, layers, B, prompt, steps = SHARDED_DECODE[0]
    return [("train_9a", "internlm2-20b", train_layers,
             ("train_9a", "train", TRAIN_SEQ, TRAIN_BATCH), "train_4k", "published"),
            ("decode_9b", arch, layers, ("decode_9b", "decode", prompt + steps, B),
             "decode_32k", "tuned")]


def roofline_vs_measured(child, train9a: dict, decode9b: dict, card: str) -> dict:
    """Phase 9d: the H100 roofline of 9a's train step and 9b's decode step,
    counted by ``op_analysis`` on ``meta`` over a 1 x 1 mesh (``child``: a
    fresh interpreter with a one-rank fake group, running ROOFLINE_CHILD),
    beside the measured medians: a step measured below ROOFLINE_FLOOR of its
    bound means a wrong count."""
    stdout, seconds = finish_child(child, 600)
    reps = json.loads(stdout.strip().splitlines()[-1])
    out = {"card": card, "seconds": seconds}
    for key, measured in (("train_9a", train9a["step_ms_p50"]),
                          ("decode_9b", decode9b["decode_step_ms_p50"])):
        r = reps[key]
        bound_ms = 1e3 * r["t_bound"]
        out[key] = {"bound_ms": bound_ms, "bound_by": r["bottleneck"],
                    "t_compute_ms": 1e3 * r["t_compute"], "t_memory_ms": 1e3 * r["t_memory"],
                    "t_collective_ms": 1e3 * r["t_collective"], "measured_ms": measured,
                    "measured_over_bound": measured / bound_ms,
                    "counted_flops": r["flops_per_chip"], "matmul_flops": r["matmul_flops"],
                    "model_flops": r["model_flops"], "hbm_bytes": r["hbm_bytes_per_chip"],
                    "hbm_bytes_op_ub": r["hbm_bytes_op_ub"], "loops": r["loops"],
                    "analysis_s": r["seconds"]}
        print(f"9d roofline {key}: {r['summary']}; bound {bound_ms:.3f} ms ({r['bottleneck']}) "
              f"against measured {measured:.3f} ms = {measured / bound_ms:.2f}x; counted flops "
              f"{r['flops_per_chip']:.4g} (matmuls {r['matmul_flops']:.4g}) beside model_flops "
              f"{r['model_flops']:.4g}; {card}")
        check(measured >= ROOFLINE_FLOOR * bound_ms,
              f"9d: {key} measured {measured:.3f} ms below {ROOFLINE_FLOOR} x its bound "
              f"{bound_ms:.3f} ms: the count is wrong")
    return out


def start_dryruns() -> dict:
    """Phase 9e (host only), started: ``python -m repro_torch.launch.dryrun``
    of DRYRUNS and DRYRUN_MORE on pod16x16, each in a fresh interpreter (a
    fake 256-rank group), all at once beside the card phases."""
    return {(arch, cell): start_child(["-m", "repro_torch.launch.dryrun", "--arch", arch,
                                       "--cell", cell, "--json"])
            for arch, cell in (*DRYRUNS, DRYRUN_MORE)}


def production_dryruns(children: dict) -> dict:
    """Phase 9e's reports: per-GPU bytes against 80 GB, the bound, the
    seconds; DRYRUN_MORE's kept when internlm2-20b's train cell took under
    DRYRUN_MORE_BELOW_S."""
    out = {}
    for (arch, cell), child in children.items():
        stdout, wall = finish_child(child, 900)
        rep = json.loads(stdout.strip().splitlines()[-1])["dryrun"][0]
        mem = rep["memory_stats"]
        seconds = mem["seconds"]   # the cell's own time (the child ran beside other work)
        if (arch, cell) == DRYRUN_MORE and out.get("internlm2-20b train_4k", {}).get(
                "seconds", DRYRUN_MORE_BELOW_S) >= DRYRUN_MORE_BELOW_S:
            continue
        out[f"{arch} {cell}"] = {
            "per_gpu_bytes": mem["per_gpu_bytes"], "argument_bytes": mem["argument_bytes"],
            "temp_bytes": mem["temp_bytes"], "fits_80GB": mem["per_gpu_bytes"] <= 80e9,
            "bound_ms": 1e3 * rep["t_bound"], "bound_by": rep["bottleneck"],
            "t_compute_ms": 1e3 * rep["t_compute"], "t_memory_ms": 1e3 * rep["t_memory"],
            "t_collective_ms": 1e3 * rep["t_collective"], "flops_per_gpu": rep["flops_per_chip"],
            "collective_bytes_per_gpu": rep["collective_bytes_per_chip"],
            "collective_by_op": rep["collective_by_op"], "useful_ratio": rep["useful_ratio"],
            "roofline_fraction": rep["roofline_fraction"], "seconds": seconds,
            "child_wall_s": wall}
        print(f"9e dryrun {arch} {cell} pod16x16: per GPU {mem['per_gpu_bytes'] / 1e9:.2f} GB "
              f"of 80 GB (args {mem['argument_bytes'] / 1e9:.2f}, temp "
              f"{mem['temp_bytes'] / 1e9:.2f}), bound {1e3 * rep['t_bound']:.1f} ms "
              f"({rep['bottleneck']}), {seconds:.1f} s")
    return out


DEPTH_CHILD = """
import sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads({threads})
import chip_smoke
for arch in {archs!r}:
    chip_smoke.check_depth(torch, arch)
"""


def start_depth_child():
    """Phase 4's published-depth checks (:func:`check_depth`) in a fresh
    interpreter on the card, started now and read by :func:`finish_child`."""
    return start_child(["-c", DEPTH_CHILD.format(root=str(ROOT), threads=DEPTH_THREADS,
                                                  archs=DEPTH_ARCHS)])


def start_host_children(train_layers: int) -> dict:
    """Phase 9d's and 9e's host-only children, started ahead (main starts
    them before phase 8's trainings: llama3-405b's dry-run takes a minute
    or more of one core, hidden under the card phases)."""
    return {"roofline": start_child(["-c", ROOFLINE_CHILD.format(
                src=str(ROOT / "src"), cases=roofline_cases(train_layers))]),
            "dryruns": start_dryruns()}


def sharding_phase(torch, train8: dict, card: str, children: dict) -> dict:
    """Phase 9: 9a-9c on the card through a 1 x 1 mesh, 9d the roofline of
    9a's and 9b's steps, 9e the production-mesh dry-runs (``children``:
    :func:`start_host_children`)."""
    t0 = time.perf_counter()
    mesh = one_card_mesh(torch)
    out = {"card": card}
    out["train"] = sharded_train(torch, mesh, train8)
    release(torch)
    print(f"phase 9a took {time.perf_counter() - t0:.1f} s")
    out["decode"] = {}
    for arch, layers, B, prompt, steps in SHARDED_DECODE:
        t1 = time.perf_counter()
        out["decode"][arch] = sharded_decode(torch, mesh, arch, layers, B, prompt, steps)
        release(torch)
        print(f"phase 9 decode {arch} took {time.perf_counter() - t1:.1f} s")
    out["card_s"] = time.perf_counter() - t0
    out["roofline"] = roofline_vs_measured(children["roofline"], out["train"],
                                           out["decode"]["internlm2-20b"], card)
    out["dryrun"] = production_dryruns(children["dryruns"])
    out["phase_s"] = time.perf_counter() - t0
    return out


# -- phase 10: the port's static analysis and its four examples --------------

# each host-only check: (python -m arguments, the exit code it must give)
ANALYSIS = (
    (("repro_torch.analysis.hamlint", "src/repro_torch"), 0),
    (("repro_torch.analysis.hamlint", "tests/fixtures/hamlint_bad_torch"), 1),
    (("repro_torch.analysis.modelcheck", "--quick"), 0),
)
# the train twin's steps and its restart step, cut to pass the restart
# in a few steps (the twin's defaults: 300 and 100)
TRAIN_DEMO = (40, 30)
# each example twin with the arguments it runs with here, besides its
# default device (the card)
EXAMPLE_RUNS = {
    "torch_serve_batched": (),
    "torch_train_e2e": ("--steps", str(TRAIN_DEMO[0]), "--log-every", "10", "--restart-demo",
                        "--restart-at", str(TRAIN_DEMO[1])),
    "torch_quickstart": (),
    "torch_offload_pipeline": (),
}
# an example as the user runs it, in a fresh interpreter, then a last line:
# its kernel launches and its seconds from its first import to its end
EXAMPLE_CHILD = """
import json, runpy, sys, time
t0 = time.perf_counter()
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
seconds = time.perf_counter() - t0
import chip_smoke
print(json.dumps({"launches": chip_smoke.read_counts(), "seconds": seconds}))
"""


def start_example(name: str, *extra: str):
    device = () if DEVICE == "cuda" else ("--device", DEVICE)   # the default: the card
    return start_child(["-c", EXAMPLE_CHILD, str(ROOT / "examples" / f"{name}.py"),
                        *EXAMPLE_RUNS[name], *device, *extra])


def finish_example(child, name: str) -> tuple[list[str], dict]:
    """The example's output lines (the counters' line taken off) and its
    launches; it exited 0."""
    stdout, _ = finish_child(child, 600)
    lines = stdout.strip().splitlines()
    res = json.loads(lines.pop())
    print(f"phase 10 {name}: {res['seconds']:.1f} s; {lines[-1]}")
    return lines, dict(res, last_line=lines[-1])


def examples_phase() -> dict:
    """Phase 10: the port's hamlint over ``src/repro_torch`` (clean) and over
    the torch fixture corpus (findings), ``modelcheck --quick`` (5 passes),
    then the four example twins on the card, each a fresh interpreter: the
    serve twin on olmoe-1b-7b at full config in bf16, the train twin
    through its restart, the two runtime examples; each exits 0 and prints
    its last line, and the serve and train runs' launches are exactly what
    their printed steps and admissions make (the runtime examples launch
    none).  The host-only checks run first; the four examples then start
    together and share the card (their counters are their own)."""
    import re

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {"analysis": {}}
    for args, code in ANALYSIS:
        stdout, wall = finish_child(start_child(["-m", *args]), 120, expect=code)
        key = " ".join(args)
        out["analysis"][key] = {"exit": code, "seconds": wall}
        if args[0].endswith("modelcheck"):
            check(stdout.count("[PASS]") == 5, f"modelcheck --quick: {stdout}")
        else:   # clean, or findings in the path:line:col: RULE format
            findings = re.findall(r"^\S+:\d+:\d+: (HAM00[1-4]) ", stdout, re.M)
            check(len(findings) == len(stdout.strip().splitlines()) and bool(findings) == bool(code),
                  f"hamlint {args[1]}: {stdout}")
            out["analysis"][key]["findings"] = len(findings)
        print(f"phase 10 {key}: exit {code}, {wall:.1f} s")
    ckpt = ROOT / "build" / "phase10_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    children = {name: start_example(name, *(("--ckpt-dir", str(ckpt)) if name ==
                                            "torch_train_e2e" else ()))
                for name in EXAMPLE_RUNS}
    serve_lines, out["torch_serve_batched"] = finish_example(
        children.pop("torch_serve_batched"), "torch_serve_batched")
    train_lines, out["torch_train_e2e"] = finish_example(
        children.pop("torch_train_e2e"), "torch_train_e2e")
    shutil.rmtree(ckpt, ignore_errors=True)
    for name, child in children.items():
        lines, out[name] = finish_example(child, name)
        check(lines[-1] == f"OK ({DEVICE})", f"{name} ended with {lines[-1]!r}")
        check(not any(out[name]["launches"].values()),
              f"{name} launched kernels: {out[name]['launches']}")

    # the serve twin: olmoe-1b-7b at its published width and depth, bf16
    cfg = get_config("olmoe-1b-7b")
    check(any(f"arch={cfg.name}  {cfg.num_layers} layers" in line
              and f"(bfloat16) on {DEVICE}" in line for line in serve_lines),
          f"torch_serve_batched: {serve_lines[:2]}")
    tokens, steps, admissions = map(int, re.search(
        r"(\d+) tokens in .* over (\d+) batched steps and (\d+) admissions",
        serve_lines[-1]).groups())
    check(tokens > 0 and admissions == 8, f"torch_serve_batched: {serve_lines[-1]}")
    want = serve_launches(cfg, steps, admissions)
    got = out["torch_serve_batched"]["launches"]
    check(got == want, f"torch_serve_batched launches {got} != {want} ({steps} steps, "
                       f"{admissions} admissions)")
    out["torch_serve_batched"].update(steps=steps, admissions=admissions, tokens=tokens)

    # the train twin: every step it ran, on the example's own config
    demo = runpy.run_path(str(ROOT / "examples" / "torch_train_e2e.py"))["CFG_100M"]
    final = re.fullmatch(r"final loss: (\S+) at step (\d+)", train_lines[-1])
    check(final is not None and np.isfinite(float(final.group(1))),
          f"torch_train_e2e: {train_lines[-1]}")
    check(f">> resumed at step {TRAIN_DEMO[1]}" in train_lines, f"torch_train_e2e: {train_lines}")
    steps = int(final.group(2))
    check(steps == TRAIN_DEMO[0], f"torch_train_e2e ran {steps} steps")
    want = dict.fromkeys(KERNELS, 0)
    want.update(train_launches(demo, steps)[0])
    got = out["torch_train_e2e"]["launches"]
    check(got == want, f"torch_train_e2e launches {got} != {want} ({steps} steps)")
    out["torch_train_e2e"].update(steps=steps, final_loss=float(final.group(1)))
    out["phase_s"] = time.perf_counter() - t0
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build  # fails outside a checkout of the repo

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    # phase 7a forks workers: before anything in this process touches a
    # CUDA context (is_available only counts the devices)
    t0 = time.perf_counter()
    fabrics = process_fabrics_forked()
    print(f"phase 7a (forked process fabrics) took {time.perf_counter() - t0:.1f} s")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sources = sorted({Path(meta["source"]).stem for meta in KERNELS.values()})
    _build.build(sources)
    print(f"built {sources} in {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for kernel, regs, spill in ptxas_summary(log):
            print(f"  nvcc {name}: {kernel}: {regs}; {spill}")

    t0 = time.perf_counter()
    records = check_kernels(torch)
    print(f"phase 3 took {time.perf_counter() - t0:.1f} s")
    for arch in MODEL_CHECKS:
        t0 = time.perf_counter()
        check_model(torch, arch)
        release(torch)
        print(f"model check {arch} took {time.perf_counter() - t0:.1f} s")
    for arch, run in (("xlstm-1.3b", check_xlstm),
                      ("xlstm-1.3b bfloat16", lambda t: check_xlstm(t, "bfloat16")),
                      ("zamba2-2.7b", check_zamba2),
                      ("zamba2-2.7b bfloat16", check_zamba2_bf16)):
        t0 = time.perf_counter()
        run(torch)
        release(torch)
        print(f"model check {arch} took {time.perf_counter() - t0:.1f} s")
    for what, run in (("zamba2-2.7b windowed", check_zamba2_window),
                      ("whisper-large-v3", check_whisper), ("internvl2-76b", check_vlm),
                      ("internlm2-20b kv_quant", check_kv_quant)):
        t0 = time.perf_counter()
        run(torch)
        release(torch)
        print(f"model check {what} took {time.perf_counter() - t0:.1f} s")
    served = {}
    for arch in SERVED:
        t0 = time.perf_counter()
        served[arch] = serve(torch, arch)
        release(torch)
        print(f"serve {arch} took {time.perf_counter() - t0:.1f} s")
    full = {}
    for what, run in (("zamba2-2.7b windowed", serve_windowed),
                      ("internlm2-20b kv_quant", decode_kv_quant),
                      ("whisper-large-v3", decode_whisper), ("internvl2-76b", decode_vlm)):
        t0 = time.perf_counter()
        full[what] = run(torch)
        full[what]["card"] = smi[0]
        release(torch)
        print(f"phase 5b {what} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cluster = cluster_serve(torch)
    cluster["card"] = smi[0]
    release(torch)
    print(f"cluster serving took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    fabrics["fresh_interpreter"] = process_fabrics_fresh(torch)
    fabrics["fresh_s"] = time.perf_counter() - t0
    fabrics["card"] = smi[0]
    release(torch)
    print(f"phase 7b (fresh-interpreter process fabrics) took {fabrics['fresh_s']:.1f} s")
    depth = start_depth_child()   # phase 4's published-depth checks, beside phases 8 and 9
    t8 = time.perf_counter()
    records.update(check_kernel_grads(torch))
    release(torch)
    print(f"phase 8a (kernel gradients) took {time.perf_counter() - t8:.1f} s")
    train = {"card": smi[0]}
    t0 = time.perf_counter()
    for arch, steps, layers in CARD_VS_CPU:
        train[f"card_vs_cpu {arch}"] = card_vs_cpu(torch, arch, steps, layers)
        release(torch)
    print(f"phase 8b/8c card vs CPU took {time.perf_counter() - t0:.1f} s")
    # phase 9's host-only children run beside the trainings (after 8b,
    # whose CPU side takes every core)
    children = start_host_children(dict((a, n) for a, n, _ in TRAINED)["internlm2-20b"])
    for arch, layers, steps in TRAINED:
        t0 = time.perf_counter()
        train[arch] = train_full(torch, arch, layers, steps)
        release(torch)
        print(f"phase 8 train {arch} took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train["checkpoint_restart"] = checkpoint_restart(torch)
    release(torch)
    print(f"phase 8d (checkpoint restart) took {time.perf_counter() - t0:.1f} s")
    train["phase_s"] = time.perf_counter() - t8
    print(f"phase 8 took {train['phase_s']:.1f} s")
    sharded = sharding_phase(torch, train["internlm2-20b"], smi[0], children)
    release(torch)
    print(f"phase 9 took {sharded['phase_s']:.1f} s (on the card {sharded['card_s']:.1f} s)")
    t0 = time.perf_counter()
    stdout, depth_s = finish_child(depth, timeout=1200)
    print(stdout.rstrip())
    print(f"model check at published depth {list(DEPTH_ARCHS)} took {depth_s:.1f} s in a child "
          f"beside phases 8 and 9 (waited {time.perf_counter() - t0:.1f} s for it)")
    examples = examples_phase()
    examples["card"] = smi[0]
    print(f"phase 10 took {examples['phase_s']:.1f} s")
    runs = [s["launches"] for s in (*served.values(), *full.values())] + [
        cluster[m]["launches"]
        for m in ("single_engine", "worker_driven", "lockstep", "worker_driven_1_worker")] + [
        train[arch]["launches"] for arch, _, _ in TRAINED] + [
        sharded["train"]["launches"], *(d["launches"] for d in sharded["decode"].values())] + [
        examples[name]["launches"] for name in EXAMPLE_RUNS]

    extra = ("ms_by_splits", "previous", "host_us", "passes_ms", "causal_ms", "causal_bound_ms",
             "window_over_causal", "turns_ms", "bf16_ms", "bf16_bound_ms", "caches_cycled",
             "ptxas", "smem_bytes", "blocks_per_sm",
             "lse_cost", "workspace_bytes", "gate_passes_ms")
    kernels = []
    for name, meta in KERNELS.items():
        rec = records[name]
        entry = {
            "name": name, "route": "cuda", "source": meta["source"],
            "replaces": meta["replaces"],
            "launches": sum(run[name] for run in runs),
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }
        if rec["library_ms"] is None:
            entry["library"] = rec["library"]
        entry["shape"] = rec["shape"]
        if "variant" in meta:
            entry["variant"] = meta["variant"]
        entry.update({k: rec[k] for k in extra if k in rec})
        for key, rec in records.items():   # the same kernel at other timed shapes
            owner = max((n for n in KERNELS if key.startswith(f"{n}_")), key=len, default=None)
            if owner == name:
                entry[key[len(name) + 1:]] = {k: rec[k] for k in (
                    "shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", *extra) if k in rec}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    for stats in served.values():
        print(json.dumps({"serve": stats}))
    print(json.dumps({"attention_paths": full}))
    print(json.dumps({"cluster_serve": cluster}))
    print(json.dumps({"process_fabrics": fabrics}))
    print(json.dumps({"train": train}))
    print(json.dumps({"sharded": sharded}))
    print(json.dumps({"examples": examples}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
