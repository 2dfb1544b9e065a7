#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it, in phases.

  1. build    compile the CUDA kernels from src/repro_torch/csrc (nvcc,
              sm_90a), print the seconds taken per source and ptxas's
              registers and spills per kernel, and count the HGMMA
              (wgmma) instructions in the SASS of each tensor-core kernel
              (none fails the run);
  2. kernels  hold each hand-written kernel against its plain PyTorch
              version at the serving path's shapes, in bf16 and f32, and
              time the kernel, the plain version, one PyTorch library call
              of the same function (CUDA events, and for the redesigned
              kernels also the profiler's device time, the scans and
              decode attention also with a cold L2), and the card's
              bound for the work; time the bf16 expert GEMM at each
              decode-sized C; hold bf16 flash to a limit that a window
              or diagonal off by one fails, bf16 decode attention to one
              that a length off by one fails, the bf16 expert GEMM to one
              that a dropped k16 slice, a cut tile or a swapped expert
              fails, and the mLSTM scan's chunkwise route to f32 limits
              that a state entering late or a mask one step too wide
              fails (shown by controls); m and the RG-LRU scan's f32
              output must be bitwise the plain versions'; then each
              backbone path's shapes, held and timed the same way: flash
              at 8 x 512 (mla: H = Kv = 16, D = 128; qwen3: H = 64, Kv =
              4, D = 64), split-KV decode at qwen3's g = 16, D = 64 (8 x
              1024), the expert GEMM at E = 64, H = 1408 and E = 128, M
              = 4096, H = 1536 at the decode and prefill C; and the
              multimodal path's new callers: flash with causal=False at
              the encoder's shape (8 x 1024 frames, H = Kv = 16, D = 64;
              f32 at TOL, bf16 at FLASH_TOL beside controls with the last
              key dropped and with a causal mask, each failing in every
              batch row) and the dense decode kernels at the
              cross-attention shape (C = 1024 every row, D = 64); the
              served configurations' shapes: flash at 8 x 512 for
              granite (H 16, Kv 8, D 64), qwen2-1.5b (g = 6, D 128),
              starcoder2 (g = 12, window 4096, and at 1 x 5120 where the
              window bites) and command-r (H 64, Kv 8, D 128), split-KV
              decode at 8 x 1024 for granite, qwen2-1.5b and command-r,
              the expert GEMM at granite's E = 32, M = 1024, H = 512; and
              the scans' backwards (the port's own kernels, no TPU
              function) against their plain versions in f32: RG-LRU at
              recurrentgemma-9b's train shape (B = 4, S = 512, W = 4096)
              bitwise, mLSTM at xlstm-1.3b's train shape (B = 4, H = 4,
              S = 512, D = 1024; the fresh state train_recurrent passes
              and a random one) and at B = 1, S = 64, the clamp off
              and on, within ``SCAN_BWD_TOL`` (relative L2 of each
              gradient), two mLSTM calls bitwise equal, each
              beside controls that must miss the limit (dh shifted by
              one step; for the mLSTM, with the clamp on, m held
              constant, and the chunkwise mirror's gate terms formed
              without dC);
     kernelcheck states  the dense and paged decode kernels over
              ``analysis.kernelcheck``'s ledger states (the paging
              manager's boundary tables, the all-unallocated table, the
              boundary lengths of caches the chunk does not divide) with
              every pool row that no live position references NaN: the
              output finite and within DECODE_TOL of the plain version,
              and a control with one live row poisoned non-finite;
  3. small    a smoke-size model on the card (kernels) against the same
              model on the CPU (plain versions): prefill and decode logits
              and greedy tokens (deepseek-v2-lite's MLA through the flash
              kernel at prefill; granite, starcoder2 past its ring's
              window and command-r among them); the vlm and audio smoke
              models through the step builders (prefill logits, the
              memory, greedy tokens); ``launch.quickstart``'s step 5 (the
              f32 SIMT expert GEMM once per MoE layer, no other kernel)
              against the same call on the CPU;
     ring     recurrentgemma-9b at full width cut to one (rec, rec, attn)
              group, f32 weights: teacher-forced decode across the local
              attention ring's wrap against prefill of the longer prompt;
  4. calibrate  the port's microbenchmarks (``profiling.calibrate``) on the
              card at bf16 over the card's sweeps: the expert path's
              GEMMs (``torch.matmul``), the flash kernel (attention) and
              the split-KV decode kernel (decode), and the copy proxy for
              the all_to_all (one card has no wire); print every
              sample, alpha, beta, R^2, proxy flag and retries, and the
              rate beta implies beside the card's peak; fail if a
              non-proxy fit has R^2 under 0.9 or beta <= 0, if either
              kernel's launches differ from the sweep's calls, or if the
              profile stored in a fresh ``ProfileStore`` does not load
              back bit for bit;
     serve    ServingEngine with the full qwen2-moe-a2.7b config (24
              layers, bf16 weights drawn from a seed on the card): 16
              requests, 8 slots, max_context 1024, on three paths, each
              run with the decode step as a CUDA graph and with the
              launch counts set to 0 just before it and read just after
              (a graph engine must replay once per decode step and
              capture no key twice): paged KV with the dense footprint as
              its pool ("paged"); dense KV ("serve"), whose greedy tokens
              the paged run must equal; paged KV under a pool that must
              preempt, with a shared system prompt ("pressure"). Each
              path is held against an eager engine (decode_graph=False)
              on the same weights: the eager engine serves the same
              requests (greedy tokens must be equal) and both take 11
              teacher-forced decode steps over 8 prompts of mixed lengths
              (logits must be bitwise equal at every step; on the paged
              paths a step must follow a table change). Paged and serve
              are profiled over 3 decode steps, graph and eager (serve
              also over one batched prefill call of 8 x 300 tokens); a
              paired decode-step timing takes turns between the dense
              graph, dense eager and paged graph engines, and one eager decode
              step of the dense engine runs under
              ``torch.cuda.set_sync_debug_mode("error")`` with no
              synchronizing call (``check_sync_guard``: a step followed
              by ``.item()`` must raise);
     dep      the same model, weights and requests with the FinDEP
              policy on the profile the calibrate phase measured (its
              plans printed beside the PAPER_A6000 ones at every prefill
              (bucket, batch) and decode occupancy met) and an NCCL
              expert group of one rank: every MoE layer walks its plan's
              program (A2E /
              EXP / E2A per (stream, chunk), all_to_all on a comm
              stream); the expert GEMM must launch 24 x sum(r1·r2) of
              each step's programs; graph against eager (greedy tokens,
              11 teacher-forced steps bitwise), interleave "streams"
              against "off" bitwise, one full-width layer against the
              capacity path (bitwise where r2 = 1 and the shared expert
              is one segment, else within GEMM_TOL); plans, captures per
              key, a decode-step and a prefill profile, expert-GEMM ms
              per launch at the chunk widths, and a paired timing of the
              DEP graph engine against the capacity graph engine; the
              engine's telemetry (measured against predicted seconds, per
              phase and per plan key);
     drift    on the same weights and requests, a dep engine with a
              drift threshold and a re-calibration whenever its store
              is older than 0 s (polled every ``DRIFT_POLL_S``): the
              calibration runs on the refresh worker, on its own stream,
              while the engine serves; every request must finish, the
              graph replay once per decode step and capture no key
              twice, the expert GEMM launch 24 x sum(r1·r2), and at
              least one re-calibration and one re-solve land before the
              serve ends; drift events, re-solves, re-calibrations and
              the programs first captured mid-serve are printed;
     placement  on the dep phase's model, requests and profile (NCCL, one
              rank): a load-tracking engine (capacity widening off)
              against an untracked one, the same greedy tokens and graph
              keys but collect_stats, the untracked step still 1
              cudaGraphLaunch and 2 cudaLaunchKernel, the tracked one no
              more launches or syncs (its extra host calls printed) and
              a paired decode-step timing; an engine
              with 2 hot experts serves half the requests, re-places
              (``rebalance_now``) and serves the rest: epoch 1, every
              skew-keyed plan at it, the expert GEMM 24 x (sum(r1·r2) +
              the REP task's r1) at every step, 11 teacher-forced steps
              bitwise against an eager twin given its tracker state and
              placement, the placed layer (REP, the widened capacity)
              within GEMM_TOL of the capacity path, the expert GEMM
              against its plain version at every (E, C) of that serve
              (REP's E=2 too; served and scaled weights, with controls),
              the REP GEMM's ms per launch at E=2; then a two-rank permutation and the uniform
              placement applied in place on the untracked engine: every
              expert tensor at its address holding the placement's rows,
              and the graphs captured before replayed bitwise against the
              eager step; expert_load(), each plan's skew and capacity
              scale, dropped against routed assignments, tokens/s and TPOT;
     obs      the port's entry point, ``repro_torch.launch.serve_moe``,
              serves the same model (--full --dep, 16 requests, 8 slots,
              max_context 1024, the calibrate phase's profile) with
              --trace-out and --metrics-out: the trace must validate and
              hold every span, the JSONL and the Prometheus text parse
              back with a TTFT count of every finished request; an
              untraced twin (tracer=None, metrics=False) on the same
              weights must give the same greedy tokens and graph keys,
              and both the same host launch calls per decode step (1
              cudaGraphLaunch, 2 cudaLaunchKernel). Then one MoE layer
              of those weights is traced on the card
              (``trace_dep_execution``: CUDA event pairs, A2E/E2A on the
              comm stream, EXP/SHARED on the compute stream) under the
              8 x 300 prefill's planned program and the forced r1=2 x
              r2=4 one, each interleaved and not: spans in walk order,
              one EXP per (stream, chunk), output bitwise the untraced
              layer's, each A2E/E2A span at least its copy's bytes
              bound; per-kind device ms, executed against scheduled
              exposed comm and the comm-under-EXP share are printed;
     mla, qwen3  the paper's two backbones at full width, bf16 weights
              from seed 0, the same 16 requests, 8 slots, max_context
              1024: deepseek-v2-lite cut to 14 of its 27 layers (MLA, 64
              experts top-6 + 2 shared) and qwen3-moe cut to 8 of its 48 layers
              (GQA 64/4, 128 experts top-8). The capacity engine serves,
              then a DEP engine on the same weights (FinDEP on the
              calibrate phase's profile, the NCCL group of one rank),
              each with the launches checked at every step (expert GEMM
              L x (steps + prefill calls), or L x sum(r1·r2) under DEP;
              flash L per prefill call; split-KV decode L per step, none
              under MLA), held against an eager twin (greedy tokens, 11
              teacher-forced steps bitwise) and profiled (decode step,
              8 x 300 prefill); a paired decode timing of capacity graph,
              capacity eager and DEP graph; the expert GEMM against its
              plain version at every (E, C) either serve gave it, with
              controls; under MLA the decode recompute (the w_ukv GEMM
              over the whole latent cache, + kpe, the masked SDPA) timed
              per layer and per step beside the expert GEMM; parameters
              against ModelConfig.num_params(), tokens/s, decode step and
              prefill-call ms, peak GB and wall seconds printed;
     granite  granite-moe-1b-a400m at full width and depth (24 layers,
              32 experts top-8, no shared expert) through the same
              protocol as mla and qwen3 but for the DEP engine's eager
              twin (cut for run time), its f32 readout timed alone
              (``time_readout``);
     qwen2-1.5b, starcoder2, command-r  the dense configurations at full
              width (28 and 30 layers; command-r-35b cut to
              ``COMMAND_R_LAYERS`` = 16 of 40 for run time), bf16 weights
              from seed 0, 8 slots, max_context 1024 (starcoder2: 5120,
              and one 4608-token prompt past its 4096 window), the same
              16 requests (``served_requests``): the graph engine with the
              launches checked at every step (flash L per prefill call,
              split-KV decode L per step, none over starcoder2's ring,
              which decodes through the plain masked SDPA), a decode and
              an 8 x 300 prefill profile, the f32 readout timed alone
              (its kernels by name and its share of the decode step's
              kernel time), then an eager twin (greedy tokens, 11
              teacher-forced steps bitwise; starcoder2's across its
              ring's wrap);
     ep       sharded serving: qwen2-moe-a2.7b at full width cut to
              ``EP_LAYERS`` (12 of 24; seed 0, bf16) on an expert group of
              two ranks, two spawned
              processes sharing the card over gloo (NCCL refuses two
              ranks of one communicator on one card), each drawing and
              holding 30 of the 60 experts (per-expert fingerprints equal
              the one-rank model's rows), in lock step: the decode graph
              over gloo is refused; the 16 requests, 8 slots,
              max_context 1024, eager, FinDEP on the calibrate phase's
              profile, every request finished and both ranks holding the
              same tokens, the launches read on each rank (expert GEMM
              L x sum(r1·r2)); the expert GEMM against its plain
              version at every (E = 30, C) of the serve; 11 teacher-forced
              steps at a capacity factor that drops nothing within
              ``EP_LOGIT_TOL`` of the one-rank engine (every expert,
              freed before the ranks start), and a control whose rank 1
              holds experts [29, 59) beyond it; a cross-rank re-placement
              (``rebalance_now``: an expert moves each way, two are
              replicated) in place, then 8 more requests; tokens/s,
              decode-step and prefill-call ms, A2E/E2A bytes and gloo's
              ms for them and peak GB per rank printed. The transport is
              host-staged gloo: no wire is measured. Then the same
              teacher-forced check in f32 at ``EP_F32_LAYERS`` (two
              ranks against the one-rank f32 engine within
              ``EP_LOGIT_TOL[torch.float32]``, routing as it does: a
              near-tie under ``EP_TIE_GAP`` routed apart by rounding is
              routed as one rank, and printed, any other reroute fails;
              the control beyond it),
              beside two baselines of one rank: its DEP walk against its
              capacity path (bf16, 24 layers) and its bf16 against its f32
              logits at ``EP_F32_LAYERS``;
  5. xlstm    ServingEngine with xlstm-1.3b at full width cut to 8 of
              its 48 layers (``XLSTM_LAYERS``: 7 mLSTM through the mLSTM
              scan kernels, 1 sLSTM): 16
              requests, 8 slots, max_context 1024, with the graph; held
              against an eager engine as in phase 4 and timed beside it;
              profiled over 3 decode steps (graph and eager) and one
              600-token prefill call;
  6. hybrid   ServingEngine with the full recurrentgemma-9b config (38
              layers: 26 RG-LRU through the RG-LRU scan kernel, 12 local
              attention through the flash kernel at prefill and over a
              ring KV cache at decode): 16 requests, 8 slots,
              max_context 4096, one prompt whose ring wraps in decode and
              one whose prefill rolls, with the graph; held against an
              eager engine (a teacher-forced ring wraps) and timed beside
              it; profiled over 3 decode steps (graph and eager) and one
              3000-token prefill call;
  7. multimodal  internvl2-1b and seamless-m4t-large-v2 at full width and
              depth (bf16 weights from seed 0), eager through the port's
              step builders: 8 rows of the stub frontend's embeddings
              (256 patches; 1024 frames, encoded by 24 bidirectional
              layers) and a 64-token prompt, one prefill step, 32 greedy
              serve steps (seamless: cross-attention over the memory in
              all 24 decoder layers at every step); the launches checked
              exactly (flash 24 causal and 24 bidirectional a prefill,
              dense decode 24 self- and 24 cross-attention calls a step),
              then 11 teacher-forced steps against ``forward`` within
              ``MM_LOGIT_TOL`` beside a control that must exceed it at
              every step (the memory rolled by one row; the patches
              shifted by one position); encode, prefill-step and
              decode-step ms, a step's kernel time, the cross K/V
              recompute's ms, tokens/s and peak GB printed;
  7b. long    qwen2-moe-a2.7b x ``SHAPES["long_500k"]`` through the launch
              layer (``adapt_for_shape``: a sliding window of 8192 over
              a ring cache; ``build``'s decode bundle): at 2 layers in
              f32, 8 decode steps across the ring's wrap against a
              prefill of the whole prompt, and the ring after them
              against the rolled prefill's (``LONG_ATOL``), beside
              controls on rings of 8191 and 8193 slots (the window edge
              one key off) that must miss it; then 24 layers in bf16, the
              bundle's abstract arguments materialised, a 12000-token
              prompt prefilled into its ring and 8 greedy serve steps,
              twice with the same tokens; ms a step, the ring's GB and
              the peak beside the unadapted cache's 103 GB; the flash
              and expert-GEMM launches checked and each kernel against
              its plain version at the path's shapes;
  8. train    training on the card (``attn_impl="xla"``, the capacity MoE
              path: the reference's ``train()`` configuration): the
              expert GEMM's autograd Function at the full-width run's
              shape (E = 60, C = 171, M = 2048, H = 1408) in f32 and bf16,
              forward and the four gradients against autograd of the
              plain version within ``TRAIN_GEMM_TOL`` (relative L2) beside
              two controls that must exceed it (expert e+1's Wd, silu'
              dropped), and the kernel's forward, its backward and
              autograd of ``torch.bmm`` x3 + SiLU timed; qwen2-moe-a2.7b
              at full width cut to 8 of its 24 layers (5.19 B params,
              bf16, AdamW with bf16 states, 41.5 GB), 6 steps of 4 x 512
              Markov tokens: every gradient leaf finite and non-zero after
              the first backward, the loss and grad norm finite at every
              step, the expert GEMM 8 launches a step and no other kernel
              (16 in a step with remat); the smoke model's step in f32 on
              the card against the CPU (loss and every gradient leaf
              within ``TRAIN_SMALL_TOL``, beside a rolled-experts
              control); the sharded train step (``build`` on a
              ``make_host_mesh``, DEP under autograd): at world size 1
              over NCCL, 8 layers, bf16, against the capacity path's
              step (every gradient leaf within ``TRAIN_DEP_TOL``, beside
              a control whose reverse exchange swaps two experts' rows),
              then two gloo ranks sharing the card (f32, 2 layers)
              against a one-rank reference (``TRAIN_DEP_TOL`` f32, the
              reverse exchange skipped as the control);
              ``python -m repro_torch.launch.train_small``
              (its ``main``) with ``--preset 100m --steps 200`` (the
              loss falls 0.2 nat or more) and ``--preset tiny --steps
              200`` (1 nat or more), each checkpoint loading back bit
              for bit;
  8b. train_recurrent  xlstm-1.3b (8 of 48 layers: 7 mLSTM + 1 sLSTM)
              and recurrentgemma-9b (6 of 38: two rec, rec, attn
              patterns) at full width, bf16 weights from seed 0, AdamW
              with bf16 states, ``TRAIN_RECURRENT_STEPS`` steps of 4 x 512
              Markov tokens under attn_impl="xla": every gradient leaf
              finite and non-zero after the first backward, the loss and
              grad norm finite, the scan's forward and backward kernels
              each launched once per scan layer at every step and no
              other kernel; a step counted on the card and on a meta twin
              (equal counts) and timed beside its least time; the scan's
              autograd Function timed at the path's shape, forward and
              backward, beside their bounds; step ms, tokens/s and peak
              GB printed;
  9. report   every phase's wall seconds and the total; one JSON line with
              every kernel's numbers (launches from the dep path for the
              kernels of qwen2-moe's dense KV, from the train_recurrent
              runs for the two backwards, and per serve or train
              path in ``launches_by_path``: the placement path's expert
              GEMM counts the REP task's launches; the backbone paths'
              shapes under ``backbones``; the expert GEMM's train shape,
              its backward ms and the comparisons under ``train``), the
              card's name and power limit, and as the last line {"ok":
              true, "device": ...}.

Any failure ends the run with a traceback and a non-zero exit. Without a
CUDA device it exits non-zero and prints no result.

Run from the repository root:  python3 chip_smoke.py
(``--no-serve`` stops after phase 3 and the ring check: a quick check of
new kernels; ``--train-only`` builds and runs phases 8 and 8b alone.) The
calibration's profile store is a temporary directory under
``.repro-profiles/``, the train loop's checkpoints are under
``.repro-train/``, all removed at the end.
``python3 tools/rehearse_chip_smoke.py`` runs phases 4-8 on the CPU at
smoke size, with a stand-in for the CUDA graph and a gloo expert group.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import weakref

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import generator_for  # noqa: E402
from repro_torch import kernels as kernel_lib  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.configs.base import DepClusterConfig  # noqa: E402
from repro_torch.core.analytic import StageTimes  # noqa: E402
from repro_torch.core.dep import DepGroups, moe_apply_dep  # noqa: E402
from repro_torch.core.perf_model import PAPER_A6000  # noqa: E402
from repro_torch.core.planner import FinDEPPlanner, PlannerConfig  # noqa: E402
from repro_torch.core.taskgraph import (ExecProgram, TaskCosts,  # noqa: E402
                                        lower_exec, schedule)
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention, decode_attention_paged)
from repro_torch.kernels.decode_attention.ops import (  # noqa: E402
    decode_attention_paged_work, decode_attention_work)
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    decode_attention_ref, gather_pages, paged_decode_attention_ref)
from repro_torch.kernels.flash_attention import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention, flash_attention_work)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.mlstm_scan import kernel as mlstm_kernel  # noqa: E402
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm_scan.ops import (  # noqa: E402
    MLSTMScanFunction, mlstm_scan, mlstm_scan_backward,
    mlstm_scan_backward_work, mlstm_scan_work)
from repro_torch.kernels.mlstm_scan.ref import (  # noqa: E402
    mlstm_scan_backward_chunkwise_ref, mlstm_scan_backward_ref,
    mlstm_scan_ref)
from repro_torch.kernels.moe_gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as gemm_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ops import (moe_gemm,  # noqa: E402
                                               moe_gemm_backward,
                                               moe_gemm_work)
from repro_torch.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro_torch.kernels.rg_lru import kernel as rglru_kernel  # noqa: E402
from repro_torch.kernels.rg_lru.ops import (  # noqa: E402
    RGLRUScanFunction, rg_lru_scan, rg_lru_scan_backward,
    rg_lru_scan_backward_work, rg_lru_scan_work)
from repro_torch.kernels.rg_lru.ref import (  # noqa: E402
    rg_lru_scan_backward_ref, rg_lru_scan_ref)
from repro_torch.analysis import kernelcheck  # noqa: E402
from repro_torch.models import ExecutionContext, build_model  # noqa: E402
from repro_torch.data import DataConfig, MarkovTextDataset  # noqa: E402
from repro_torch.launch import quickstart  # noqa: E402
from repro_torch.launch import serve_moe  # noqa: E402
from repro_torch.launch import train_small as train_small_cli  # noqa: E402
from repro_torch.configs import SHAPES  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import dep as dep_lib  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import build as build_bundle  # noqa: E402
from repro_torch.launch.steps import (LONG_CONTEXT_WINDOW,  # noqa: E402
                                      abstract_params, adapt_for_shape,
                                      decode_cache_specs, frontend_inputs,
                                      loss_and_grads, make_model,
                                      make_prefill_step, make_serve_step,
                                      make_train_step, shard_batch,
                                      sharded_decode,
                                      sharded_loss_and_grads)
from repro_torch import roofline  # noqa: E402
from repro_torch.roofline import StepCounter  # noqa: E402
from repro_torch.sharding.partition import (distribute_params,  # noqa: E402
                                            gather_shards)
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.attention import is_ring  # noqa: E402
from repro_torch.models import transformer as transformer_lib  # noqa: E402
from repro_torch.models.layers import dense_apply  # noqa: E402
from repro_torch.placement import (Placement, SkewSummary,  # noqa: E402
                                   rebalance)
from repro_torch.obs import (attribute_overlap, interval_subtract,  # noqa: E402
                             interval_total, interval_union, lane_intervals,
                             parse_prometheus, trace_dep_execution,
                             validate_chrome_trace)
from repro_torch.profiling import (ProfileKey, ProfileStore,  # noqa: E402
                                   calibrate)
from repro_torch.profiling.microbench import (sweep_counts,  # noqa: E402
                                              sweeps_for)
from repro_torch.runtime import Request, RequestState, ServingEngine  # noqa: E402
from repro_torch.runtime.decode_graph import GraphKey  # noqa: E402
from repro_torch.runtime.engine import prefill_split  # noqa: E402
from repro_torch.sched.occupancy import bucket_length  # noqa: E402
from repro_torch.sched import FinDEPPolicy, PlanCache  # noqa: E402
from repro_torch.training import (AdamWConfig, apply_updates,  # noqa: E402
                                  init_opt_state, load_checkpoint)
from repro_torch.training.tree import (tree_leaves,  # noqa: E402
                                       tree_map, tree_unflatten)

# H100 SXM published peaks (NVIDIA data sheet; dense, full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
#: f32-accurate products on the tensor cores: 3xTF32 takes three TF32
#: products (495 TFLOP/s) for one, so a kernel that runs its f32 products
#: so (the mLSTM backward) is priced at this rate, not the 67 of FFMA
PEAK_FLOPS_3XTF32 = 495e12 / 3
# f32: summation order differs; bf16: the reference's kernel tolerance
# (tests/test_kernels.py:19-20)
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=5e-2)}
# bf16 flash: a typical output is 0.04-0.3 in size, so the reference's
# atol of 5e-2 would pass a mask off by one key. The kernel rounds P to
# bf16 as the reference does (flash_attention/kernel.py:76) and the plain
# version does not; on rows that see a few keys that moves a small output
# by a few 1e-3, so atol is 5e-3 (the worst ratio each check prints is
# the margin). check_flash_controls shows that an off-by-one mask fails
# this limit.
FLASH_TOL = {torch.float32: TOL[torch.float32],
             torch.bfloat16: dict(rtol=2e-2, atol=5e-3)}
# bf16 decode attention: an output row over 300-1024 positions is 0.05-0.1
# in size, so the reference's atol of 5e-2 would pass a row that drops or
# adds a position (~3e-3 of change in its typical entry). Kernel and plain
# version both round an f32 result to bf16, so a sound output differs by
# at most one bf16 step (2^-7 relative), which rtol covers; atol 2e-3
# only has to cover entries near zero. check_decode_controls shows that a
# length off by one, or a chunk read one position late, fails this limit.
DECODE_TOL = {torch.float32: TOL[torch.float32],
              torch.bfloat16: dict(rtol=2e-2, atol=2e-3)}
# bf16 expert GEMM: an output entry is about 0.6 in size at check_moe_gemm's
# inputs, so TOL's atol of 5e-2 is a tenth of an entry. The kernel stores
# y in bf16 as the plain version does (at most one bf16 step apart, 2^-7
# relative, which rtol covers) and also rounds the SwiGLU activation to
# bf16 before the down product (the Pallas kernel does too, the plain
# version does not), a few 1e-3 on entries near zero, which atol covers.
# check_moe_gemm_controls shows that one k16 slice of the gate/up
# reduction dropped, the down reduction cut by one 64-deep tile, or one
# expert's weights swapped for its neighbour's fails this limit in every
# row it changes.
GEMM_TOL = {torch.float32: TOL[torch.float32],
            torch.bfloat16: dict(rtol=1e-2, atol=1e-2)}


def fail(msg: str):
    raise RuntimeError(msg)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def is_annotation(e) -> bool:
    """A device event that marks a collective's span ("nccl:all_to_all")
    over the copies or kernels it ran, not a kernel of its own."""
    return e.name.startswith("nccl:")


def device_events(prof):
    """The profiler's device events: kernels, copies and sets, without
    the collectives' span annotations."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not is_annotation(e)]


#: device events per wrapper call of the repo's kernels, by the name
#: filter ``device_ms`` is given: two launches for the expert GEMM (SwiGLU,
#: then down) and decode attention (split, then combine), one otherwise
PER_CALL = {"decode_attention_": 2, "decode_attention_split": 1,
            "decode_attention_combine": 1, "moe_gemm_": 2,
            "flash_attention_": 1, "mlstm_chunk_prep": 1,
            "mlstm_chunk_scan": 1, "rg_lru_scan": 1,
            "rg_lru_scan_backward": 1, "mlstm_bwd_": 8}


def trace_span(prof) -> str:
    """Where a trace's device events lie against its host events (us from
    the first host event): what a short trace lost."""
    host = [e.time_range for e in prof.events()
            if e.device_type != torch.autograd.DeviceType.CUDA]
    dev = [e.time_range for e in device_events(prof)]
    if not host or not dev:
        return f"{len(host)} host and {len(dev)} device events"
    t0 = min(r.start for r in host)
    return (f"host events {0:.0f}..{max(r.end for r in host) - t0:.0f} us, "
            f"device events {min(r.start for r in dev) - t0:.0f}.."
            f"{max(r.end for r in dev) - t0:.0f} us")


#: the kernel ``torch.cuda._sleep`` launches, which ``device_ms`` puts
#: between a lead call and the measured calls, and its length in cycles
#: (about 10 us)
LEAD_MARK = "spin_kernel"
LEAD_MARK_CYCLES = 20000


def device_ms(fn, kernel=None, iters: int = 10, per_call=None,
              bound=None, lead: bool = False, by_name=None) -> float:
    """Mean device time per call of ``fn`` of the kernels whose name
    contains ``kernel`` (every device kernel of the call when ``kernel``
    is None), from torch.profiler: unlike ``time_ms`` it holds no host
    time, which dominates a kernel of a few microseconds.

    The profiler now and then drops device events, which reads short. So
    a trace counts only when it holds every event: ``per_call`` (default
    ``PER_CALL[kernel]``) matching events per call, or, where that is not
    known (plain versions, library calls), a count that an earlier trace
    of the same calls gave too. A short trace is taken again, six in
    all; then the reading fails. A reading below ``bound`` (ms, the least
    time the card could take) fails too. ``lead`` runs ``fn`` once more
    inside the trace, before the measured calls, and counts only the
    device events that start after it: the profiler can lose the first
    events of a trace (a call of a few thousand small kernels lost its
    first 29 late in a run; the mLSTM backward's 25 kernels read 24 in
    six traces in a row), and the lead call takes that loss. So every
    trace after a short one leads. The lead call is followed by a marker
    kernel (``torch.cuda._sleep``'s ``spin_kernel``), and only the events
    that start after the marker's end on the device clock count: the
    profiler's host and device clocks can sit a millisecond or more apart
    (a trace's device events read from -16 us against its first host
    event), so a host-side range start dropped every event of a short
    call. A trace that lost the marker is short. ``by_name``, a dict,
    takes the whole trace's device ms per call of each kernel, by its
    short name."""
    if per_call is None:
        per_call = PER_CALL.get(kernel)
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for attempt in range(6):
        lead = lead or attempt > 0
        with torch.profiler.profile(activities=acts) as prof:
            if lead:
                fn()
                torch.cuda._sleep(LEAD_MARK_CYCLES)
                torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        t0 = float("-inf")
        if lead:
            marks = [e.time_range.end for e in device_events(prof)
                     if LEAD_MARK in e.name]
            t0 = max(marks, default=float("inf"))
        events = [e for e in device_events(prof)
                  if (kernel is None or kernel in e.name)
                  and e.time_range.start >= t0
                  and LEAD_MARK not in e.name]
        n = len(events)
        if per_call is not None:
            whole = n == per_call * iters
        else:
            whole = n > 0 and n % iters == 0 and n in seen
        seen.append(n)
        if whole:
            ms = sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
            for e in events if by_name is not None else ():
                k = _short(e.name)
                by_name[k] = (by_name.get(k, 0.0)
                              + e.time_range.elapsed_us() / 1e3 / iters)
            if lead:
                print(f"  device_ms: {n} device events in {iters} calls "
                      f"after the lead call (traces: {seen})")
            break
        if per_call is not None or len(seen) > 1:
            print(f"  device_ms: {n} {kernel or 'device'} events in a trace "
                  f"of {iters} calls; {trace_span(prof)}; again")
    else:
        want = (f"{per_call * iters}" if per_call is not None
                else "two traces that agree")
        fail(f"device_ms: no whole trace of {kernel or 'the kernels'} in "
             f"{len(seen)}: {seen} device events, want {want}")
    if bound is not None and ms < bound:
        fail(f"device_ms: {kernel or 'the kernels'} read {ms:.4f} ms, below "
             f"the card's bound of {bound:.4f} ms")
    return ms


def timed(fn, kernel=None, iters: int = 10, per_call=None,
          bound=None, by_name=None) -> tuple:
    """(CUDA-event ms, profiler device ms) of ``fn``."""
    return time_ms(fn, iters=iters), device_ms(fn, kernel, iters=iters,
                                               per_call=per_call,
                                               bound=bound, by_name=by_name)


def bound_ms(nbytes: float, flops: float, dtype, peak=None) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def work_bound(work, *operands, dtype=None) -> tuple:
    """``bound_ms`` of a kernel call's work as its wrapper counts it
    (``*_work``: the same count a step's roofline reads), in ``dtype``
    (default the first operand's)."""
    flops, nbytes = work(*operands)
    return bound_ms(nbytes, flops, dtype or operands[0].dtype)


def _worst(g, w, tol) -> float:
    """The largest |g - w| over its limit atol + rtol |w|: above 1 fails."""
    return float(((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs()))
                 .max())


def compare(name: str, got, want, dtype, tol=None) -> float:
    tol = tol or TOL[dtype]
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"version {tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = float((g - w).abs().max())
    worst = _worst(g, w, tol)
    ok = torch.allclose(g, w, **tol)
    print(f"  {name}: max_abs_err={err:.3e} (rtol={tol['rtol']}, "
          f"atol={tol['atol']}; worst {worst:.2f} of the limit) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel disagrees with its plain version")
    return err


def randn(gen, shape, dtype, scale=1.0):
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

#: the tensor-core kernels, by the name their SASS functions carry
WGMMA_KERNELS = ("moe_gemm_wgmma_kernel", "flash_attention_wgmma_kernel")


def phase_build() -> None:
    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    info = build.last_build
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True).stdout
    print(f"[build] {'compiled' if info.get('compiled') else 'cached'} "
          f"{len(build.sources())} sources into {build.library_path().name}"
          f" in {dt:.1f} s ({nvcc.strip().splitlines()[-1]})")
    for name, secs in info.get("per_source", {}).items():
        print(f"  {name}: {secs:.1f} s")
    for line in ptxas_summary(str(info.get("report", ""))):
        print("  " + line)
    sass_hgmma()


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True)
    out = res.stdout.splitlines()
    return out if len(out) == len(names) else list(names)


def ptxas_summary(report: str):
    """One line per compiled kernel from ptxas -v: registers, spills,
    shared memory; and every ptxas warning (e.g. a serialised wgmma)."""
    rows, cur, lines = [], None, []
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = [m.group(1), "", ""]
            rows.append(cur)
        elif cur is not None and "spill stores" in line:
            cur[1] = line.strip()
        elif cur is not None and "Used" in line and "registers" in line:
            cur[2] = line.split(":", 1)[-1].strip()
        if "warning" in line.lower():
            lines.append("ptxas " + line.strip())
    for (_, spill, used), name in zip(rows, _demangle([r[0] for r in rows])):
        lines.append(f"{_short(name)}: {used}; {spill}")
    return lines


def _short(name: str) -> str:
    """A demangled kernel name without namespace, return type or
    parameter list: ``moe_gemm_wgmma_kernel<true>``."""
    name = name.replace("(anonymous namespace)::", "")
    name = re.sub(r"^void ", "", name)
    return name.split("(")[0][:70]


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    beside = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if os.path.exists(beside):
        return beside
    spec = importlib.util.find_spec("triton")
    if spec and spec.origin:
        path = os.path.join(os.path.dirname(spec.origin), "backends",
                            "nvidia", "bin", "cuobjdump")
        if os.path.exists(path):
            return path
    fail("cuobjdump not found (CUDA toolkit or triton/backends/nvidia/bin)")


def sass_hgmma() -> None:
    """Count the HGMMA (wgmma) instructions in the SASS of each tensor-core
    kernel of the built library; fail if one has none."""
    sass = subprocess.run([_cuobjdump(), "--dump-sass",
                           str(build.library_path())], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    counts, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur is not None and "HGMMA" in line:
            counts[cur] += 1
    names = [n for n in counts if any(k in n for k in WGMMA_KERNELS)]
    for kernel in WGMMA_KERNELS:
        if not any(kernel in n for n in names):
            fail(f"sass: no function named {kernel} in the library")
    for name, short in zip(names, map(_short, _demangle(names))):
        print(f"  SASS {short}: {counts[name]} HGMMA")
        if counts[name] == 0:
            fail(f"sass: {short} has no HGMMA instruction")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _decode_inputs(gen, B, H, Kv, D, C, dtype):
    return (randn(gen, (B, H, D), dtype), randn(gen, (B, C, Kv, D), dtype),
            randn(gen, (B, C, Kv, D), dtype))


def check_repeat(name: str, fn) -> None:
    """Two identical calls give the same bits (no atomics, a fixed
    combine order)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name}: two identical calls differ")
    print(f"  {name}: two identical calls bitwise equal")


def check_decode_controls(name: str, got, q, k, v, lengths) -> float:
    """Hold the kernels' bf16 output against plain versions that are off
    by one: every length one shorter and one longer (clamped to [0, C]),
    and chunk 1 (positions P..2P-1) read one position late. Every row
    that a control changes must fail DECODE_TOL in it, or the check could
    not see such a fault in that row. Returns the least of the rows'
    worst ratios."""
    tol = DECODE_TOL[torch.bfloat16]
    C = k.shape[1]
    P = dec_kernel.CHUNK
    lens = lengths.clamp(0, C)
    g = got.float()
    controls = {}
    for d in (-1, 1):
        lc = (lens + d).clamp(0, C)
        controls[f"length{d:+d}"] = (lc, k, v, lc != lens)
    ks, vs = k.clone(), v.clone()
    end = min(2 * P, C - 1)         # a cache shorter than two chunks
    ks[:, P:end] = k[:, P + 1:end + 1]
    vs[:, P:end] = v[:, P + 1:end + 1]
    controls["chunk 1 one position late"] = (lens, ks, vs, lens > P)
    ratios = {}
    for label, (lc, kc, vc, rows) in controls.items():
        if not bool(rows.any()):
            continue
        w = decode_attention_ref(q, kc, vc, lc).float()
        per_row = ((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())) \
            .flatten(1).amax(1)
        ratios[label] = float(per_row[rows].min())
    print(f"  {name} controls (least over the rows each changes): " +
          ", ".join(f"{label} {r:.1f}x the limit"
                    for label, r in ratios.items()))
    for label, r in ratios.items():
        if r <= 1:
            fail(f"{name}: the control {label} passes DECODE_TOL in a row: "
                 "the check cannot see that fault there")
    return min(ratios.values())


def decode_bound(lengths, B, H, Kv, D, C, dtype, bs: int = 0):
    """The card's least time for the call (``decode_attention_work``): q
    and out once, each live position's K and V row once, the lengths
    (and, paged with pages of ``bs`` rows, the table entries of the live
    pages)."""
    q = meta((B, H, D), dtype)
    if not bs:
        kv = meta((B, C, Kv, D), dtype)
        return work_bound(decode_attention_work, q, kv, kv, lengths)
    pages = meta((1, bs, Kv, D), dtype)
    table = meta((B, C // bs), torch.int32)
    return work_bound(decode_attention_paged_work, q, pages, pages, lengths,
                      table)


def time_decode(label, q, k, v, lengths):
    """Events and device time of the kernels (split and combine apart),
    of the plain version and of F.scaled_dot_product_attention with the
    length mask (it reads all C positions of every row), the kernels' and
    SDPA's device time with a cold L2, and the device time of one sum
    over as many bytes as the live K/V rows, what this card reads in one
    kernel at this size."""
    B, H, D = q.shape
    C, Kv = k.shape[1], k.shape[2]
    kt = k.transpose(1, 2).repeat_interleave(H // Kv, dim=1).contiguous()
    vt = v.transpose(1, 2).repeat_interleave(H // Kv, dim=1).contiguous()
    mask = (torch.arange(C, device="cuda")[None, :]
            < lengths[:, None])[:, None, None, :]
    def run():
        return decode_attention(q, k, v, lengths)

    def sdpa():
        return F.scaled_dot_product_attention(q[:, :, None, :], kt, vt,
                                              attn_mask=mask)

    ms, dev = timed(run, "decode_attention_")
    split = device_ms(run, "decode_attention_split")
    combine = device_ms(run, "decode_attention_combine")
    plain, plain_dev = timed(lambda: decode_attention_ref(q, k, v, lengths))
    lib, lib_dev = timed(sdpa)
    # repeated calls find their K/V in the 50 MB L2; a decode step reads
    # each layer's cache once, so also time each call after a 64 MB write
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush_ms = device_ms(flush.zero_)
    cold = device_ms(lambda: (flush.zero_(), run()), "decode_attention_")
    lib_cold = device_ms(lambda: (flush.zero_(), sdpa())) - flush_ms
    b, by = decode_bound(lengths, B, H, Kv, D, C, q.dtype)
    # what the card reads at this size: one sum over the live K/V bytes
    live = torch.ones(int(lengths.clamp(0, C).sum()) * Kv * D * 2,
                      dtype=q.dtype, device="cuda")
    read = device_ms(lambda: live.sum(dtype=torch.float32))
    print(f"  {label}: kernels {ms:.4f} ms events, {dev:.4f} ms device "
          f"(split {split:.4f}, combine {combine:.4f}), {cold:.4f} ms device "
          f"with a cold L2; plain {plain:.3f} / {plain_dev:.4f} ms; "
          f"F.scaled_dot_product_attention {lib:.4f} / {lib_dev:.4f} ms, "
          f"{lib_cold:.4f} ms with a cold L2; bound {b:.4f} ms ({by}), the "
          f"kernels at {b / dev:.1%} of it ({b / cold:.1%} cold); a sum over "
          f"the live K/V bytes {read:.4f} ms device")
    return dict(ms=ms, device_ms=dev, split_device_ms=split,
                combine_device_ms=combine, cold_device_ms=cold,
                plain_ms=plain, plain_device_ms=plain_dev, library_ms=lib,
                library_device_ms=lib_dev, library_cold_device_ms=lib_cold,
                bound_ms=b, bound_by=by, live_sum_device_ms=read)


def check_decode(gen):
    """Both dtypes against the plain version at the timed shape (exact
    zeros for length 0, the same bits twice), rows at the chunk's edges,
    GQA g=6 at a C that is no chunk multiple, what the wrapper refuses,
    and the serve paths' shapes: 8 rows at ~300 positions (the decode
    profile's) and B=1 at 1024. Times at the timed and serve shapes."""
    print("[kernels] decode_attention")
    B, H, Kv, D, C = 8, 16, 16, 128, 1024
    P = dec_kernel.CHUNK
    lengths = torch.tensor([0, 1, C, 37, 500, 1000, 33, 613],
                           dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_inputs(gen, B, H, Kv, D, C, dtype)
        out = decode_attention(q, k, v, lengths)
        zero_rows = out[lengths == 0].float().abs().max()
        if float(zero_rows) != 0.0:
            fail("decode_attention: a length-0 row is not exactly zero")
        name = f"B={B} H={H} Kv={Kv} D={D} C={C} {dtype}"
        errs[dtype] = compare(name, out,
                              decode_attention_ref(q, k, v, lengths), dtype,
                              DECODE_TOL[dtype])
        if dtype == torch.bfloat16:
            check_decode_controls(name, out, q, k, v, lengths)
        check_repeat(f"B={B} C={C} {dtype}",
                     lambda: decode_attention(q, k, v, lengths))
    # the chunk's edges: P - 1, P, P + 1 (a chunk with one live position),
    # 2P + 1, C; g=4, C no multiple of P
    edge = torch.tensor([0, 1, P - 1, P, P + 1, 2 * P + 1, 1000],
                        dtype=torch.int32, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_inputs(gen, 7, 16, 4, D, 1000, dtype)
        name = f"lengths {edge.tolist()} g=4 C=1000 {dtype}"
        out = decode_attention(q, k, v, edge)
        compare(name, out, decode_attention_ref(q, k, v, edge), dtype,
                DECODE_TOL[dtype])
        if dtype == torch.bfloat16:
            check_decode_controls(name, out, q, k, v, edge)
    # GQA (qwen2-1.5b heads) and a cache length that is no chunk multiple
    lg = torch.tensor([600, 0, 17, 333], dtype=torch.int32, device="cuda")
    q, k, v = _decode_inputs(gen, 4, 12, 2, 128, 600, torch.float32)
    compare("GQA g=6 C=600 f32", decode_attention(q, k, v, lg),
            decode_attention_ref(q, k, v, lg), torch.float32,
            DECODE_TOL[torch.float32])
    # what the wrapper refuses: the 16-byte copies need D * elem % 16 == 0
    # and 16-byte-aligned K and V
    q, k, v = _decode_inputs(gen, 2, 4, 2, 12, 64, torch.bfloat16)
    kv_off = torch.empty(2 * 64 * 2 * 16 + 1, dtype=torch.bfloat16,
                         device="cuda")[1:].view(2, 64, 2, 16)
    q16 = randn(gen, (2, 4, 16), torch.bfloat16)
    for label, args in (("D=12 bf16", (q, k, v)),
                        ("K/V 2 bytes past an aligned address",
                         (q16, kv_off, kv_off))):
        try:
            decode_attention(*args, lg[:2].contiguous())
        except ValueError as e:
            print(f"  refuses {label}: {e}")
        else:
            fail(f"decode_attention: accepted {label}")

    dtype = torch.bfloat16
    q, k, v = _decode_inputs(gen, B, H, Kv, D, C, dtype)
    timing = time_decode(f"B={B} C={C} lengths {lengths.tolist()} bf16",
                         q, k, v, lengths)
    serve = {}
    rng = np.random.RandomState(5)
    for label, lens in (
            ("B=8 ~300 positions", rng.randint(290, 311, size=8)),
            ("B=1 1024 positions", np.array([1024]))):
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v = _decode_inputs(gen, len(lens), H, Kv, D, C, dtype)
        out = decode_attention(q, k, v, lt)
        compare(f"{label} C={C} bf16", out, decode_attention_ref(q, k, v, lt),
                dtype, DECODE_TOL[dtype])
        check_decode_controls(f"{label} C={C} bf16", out, q, k, v, lt)
        serve[label] = dict(time_decode(f"{label} C={C} bf16", q, k, v, lt),
                            lengths=lens.tolist())
    return dict(name="decode_attention", source=dec_kernel.SOURCE,
                replaces=dec_kernel.REPLACES, max_abs_err=errs[dtype],
                **timing, serve_shapes=serve,
                shape=f"B={B} H={H} Kv={Kv} D={D} C={C} lengths="
                      f"{lengths.tolist()} bf16")


def paged_layout(lengths, n_blocks: int, bs: int, pool: int, seed: int):
    """A block table for ``lengths``: each row's blocks are pages drawn
    without replacement from pages 1..pool-1 (page 0 is the reserved
    scratch page), -1 past the row's blocks."""
    order = list(np.random.RandomState(seed).permutation(
        np.arange(1, pool)))
    tbl = np.full((len(lengths), n_blocks), -1, np.int32)
    for b, n in enumerate(lengths):
        for c in range(-(-n // bs)):
            tbl[b, c] = order.pop()
    return torch.from_numpy(tbl).cuda()


def check_paged_equals_dense(label, q, kp, vp, lengths, tbl) -> float:
    """The paged kernels against their plain version (exact zeros for
    length 0), then bitwise against the dense kernels over the gathered
    contents. Returns the largest error."""
    out = decode_attention_paged(q, kp, vp, lengths, tbl)
    if float(out[lengths == 0].float().abs().max()) != 0.0:
        fail("decode_attention_paged: a length-0 row is not exactly zero")
    err = compare(label, out,
                  paged_decode_attention_ref(q, kp, vp, lengths, tbl),
                  q.dtype, DECODE_TOL[q.dtype])
    kd = gather_pages(kp, tbl).contiguous()
    vd = gather_pages(vp, tbl).contiguous()
    if q.dtype == torch.bfloat16:
        check_decode_controls(label, out, q, kd, vd, lengths)
    dense = decode_attention(q, kd, vd, lengths)
    torch.cuda.synchronize()
    if not torch.equal(out, dense):
        fail(f"decode_attention_paged {label}: not bitwise equal to the "
             "dense kernel on the gathered contents")
    print(f"  {label}: bitwise equal to the dense kernel on the gathered "
          "contents")
    return err


def check_decode_paged(gen):
    """Both dtypes against the plain version and bitwise against the
    dense kernels on the gathered contents and against themselves; page
    sizes below, at and above the chunk (one that does not divide it);
    GQA g=6 at bs=16; then the times beside the dense kernels' on the
    same contents."""
    print("[kernels] decode_attention_paged")
    B, H, Kv, D, bs, n_blocks, pool = 8, 16, 16, 128, 32, 32, 257
    P = dec_kernel.CHUNK
    lens_list = [0, 1, 1024, 37, 500, 1000, 33, 613]
    lengths = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    tbl = paged_layout(lens_list, n_blocks, bs, pool, seed=3)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (B, H, D), dtype)
        kp = randn(gen, (pool, bs, Kv, D), dtype)
        vp = randn(gen, (pool, bs, Kv, D), dtype)
        errs[dtype] = check_paged_equals_dense(
            f"B={B} H={H} Kv={Kv} D={D} bs={bs} blocks={n_blocks} {dtype}",
            q, kp, vp, lengths, tbl)
        check_repeat(f"paged bs={bs} {dtype}",
                     lambda: decode_attention_paged(q, kp, vp, lengths, tbl))
    # page sizes against the chunk: below and dividing it, below and not
    # dividing it, equal, above; lengths at the chunk's edges
    edge = [0, 1, P - 1, P, P + 1, 2 * P + 1, 300]
    et = torch.tensor(edge, dtype=torch.int32, device="cuda")
    for pbs in (16, 48, P, 80):
        nb = -(-300 // pbs)
        pool_e = len(edge) * nb + 1
        tg = paged_layout(edge, nb, pbs, pool_e, seed=pbs)
        q = randn(gen, (len(edge), 8, D), torch.float32)
        kp = randn(gen, (pool_e, pbs, 2, D), torch.float32)
        vp = randn(gen, (pool_e, pbs, 2, D), torch.float32)
        check_paged_equals_dense(f"g=4 bs={pbs} lengths {edge} f32",
                                 q, kp, vp, et, tg)
    # GQA g=6 at a page size that is not the chunk
    lg = [600, 0, 17, 333]
    tg = paged_layout(lg, 38, 16, 65, seed=4)
    q = randn(gen, (4, 12, 128), torch.float32)
    kp = randn(gen, (65, 16, 2, 128), torch.float32)
    vp = randn(gen, (65, 16, 2, 128), torch.float32)
    lgt = torch.tensor(lg, dtype=torch.int32, device="cuda")
    check_paged_equals_dense("GQA g=6 bs=16 f32", q, kp, vp, lgt, tg)

    dtype = torch.bfloat16
    q = randn(gen, (B, H, D), dtype)
    kp = randn(gen, (pool, bs, Kv, D), dtype)
    vp = randn(gen, (pool, bs, Kv, D), dtype)
    kd = gather_pages(kp, tbl).contiguous()
    vd = gather_pages(vp, tbl).contiguous()
    def paged():
        return decode_attention_paged(q, kp, vp, lengths, tbl)

    def dense():
        return decode_attention(q, kd, vd, lengths)

    ms, dev = timed(paged, "decode_attention_")
    dense_ms, dense_dev = timed(dense, "decode_attention_")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    cold = device_ms(lambda: (flush.zero_(), paged()), "decode_attention_")
    dense_cold = device_ms(lambda: (flush.zero_(), dense()),
                           "decode_attention_")
    plain, plain_dev = timed(
        lambda: paged_decode_attention_ref(q, kp, vp, lengths, tbl))
    b, by = decode_bound(lengths, B, H, Kv, D, n_blocks * bs, dtype, bs)
    print(f"  bf16: kernels {ms:.4f} ms events, {dev:.4f} ms device, "
          f"{cold:.4f} ms with a cold L2; the dense kernels on the same "
          f"contents {dense_ms:.4f} / {dense_dev:.4f} / {dense_cold:.4f} ms "
          f"(paged / dense device {dev / dense_dev:.3f}, cold "
          f"{cold / dense_cold:.3f}); plain {plain:.3f} / {plain_dev:.4f} "
          f"ms; bound {b:.4f} ms ({by})")
    return dict(name="decode_attention_paged", source=dec_kernel.SOURCE,
                replaces=dec_kernel.PAGED_REPLACES, max_abs_err=errs[dtype],
                ms=ms, device_ms=dev, cold_device_ms=cold, plain_ms=plain,
                plain_device_ms=plain_dev, bound_ms=b, bound_by=by,
                library_ms=None, dense_kernel_ms=dense_ms,
                dense_kernel_device_ms=dense_dev,
                dense_kernel_cold_device_ms=dense_cold,
                shape=f"B={B} H={H} Kv={Kv} D={D} bs={bs} blocks={n_blocks} "
                      f"pool={pool} lengths={lens_list} bf16")


# mLSTM: the summation order differs (matrix products per chunk, warp
# reductions, against the plain version's per-step einsum) over a
# recurrence of up to 600 steps; f32 throughout. m is compared bitwise.
MLSTM_TOL = dict(rtol=1e-4, atol=1e-4)


def mlstm_inputs(gen, B, H, S, D, fresh=False):
    """Random q/k/v/gates and a non-zero incoming state, or the state
    models/ssm.mlstm_state makes (C = n = 0, m = -1e30) with ``fresh``."""
    q = randn(gen, (B, H, S, D), torch.float32)
    k = randn(gen, (B, H, S, D), torch.float32, D ** -0.5)
    v = randn(gen, (B, H, S, D), torch.float32)
    ig = randn(gen, (B, H, S), torch.float32)
    lf = F.logsigmoid(randn(gen, (B, H, S), torch.float32) + 3.0)
    C0 = randn(gen, (B, H, D, D), torch.float32, 0.1)
    n0 = randn(gen, (B, H, D), torch.float32, 0.1)
    m0 = randn(gen, (B, H), torch.float32)
    if fresh:
        C0, n0, m0 = C0.zero_(), n0.zero_(), m0.fill_(-1e30)
    return q, k, v, ig, lf, C0, n0, m0


def mlstm_control_ref(q, k, v, ig, lf, C0, n0, m0, late_at=None,
                      peek=False, stale_m=False):
    """The plain recurrence with one slip, for the checks' controls:
    ``late_at`` — the carried state enters the chunk that starts at that
    step one step late (its first h sees only its own step's update);
    ``peek`` — the decay mask includes s = t + 1 within a chunk (h_t also
    sees step t + 1's v, weighted as the chunkwise form would);
    ``stale_m`` — the carried state's decay g_t is formed with m_{t-1}
    where m_t belongs (g_t exp(m_t - m_{t-1}) in place of g_t: an index
    slip by one step in the m track). Returns h."""
    L = mlstm_kernel.CHUNK
    C, n, m = C0, n0, m0
    hs = []
    S = q.shape[2]
    for t in range(S):
        qt, kt, vt = q[:, :, t], k[:, :, t], v[:, :, t]
        if t % L == 0:
            Cc, nc, g = C, n, 1.0     # the carried state and its decay
        m_new = torch.maximum(lf[:, :, t] + m, ig[:, :, t])
        f_p = torch.exp(lf[:, :, t] + m - m_new)[..., None]
        i_p = torch.exp(ig[:, :, t] - m_new)[..., None]
        n = f_p * n + i_p * kt
        C = f_p[..., None] * C + (i_p * vt)[..., None] * kt[..., None, :]
        Cq = torch.einsum("bhvd,bhd->bhv", C, qt)
        nq = torch.einsum("bhd,bhd->bh", n, qt)
        g = g * f_p[..., 0]
        if stale_m:
            extra = (torch.exp(m_new - m) - 1.0) * g
            Cq = Cq + extra[..., None] * torch.einsum("bhvd,bhd->bhv", Cc,
                                                      qt)
            nq = nq + extra * torch.einsum("bhd,bhd->bh", nc, qt)
        if t == late_at:
            Cq = (i_p * vt) * torch.einsum("bhd,bhd->bh", kt, qt)[..., None]
            nq = i_p[..., 0] * torch.einsum("bhd,bhd->bh", kt, qt)
        if peek and (t + 1) % L != 0 and t + 1 < S:
            w = torch.exp(ig[:, :, t + 1] - lf[:, :, t + 1] - m_new)
            kq = torch.einsum("bhd,bhd->bh", k[:, :, t + 1], qt)
            Cq = Cq + (w * kq)[..., None] * v[:, :, t + 1]
            nq = nq + w * kq
        hs.append(Cq / torch.clamp(nq.abs(), min=1.0)[..., None])
        m = m_new
    return torch.stack(hs, dim=2)


def _mlstm_outs(fn, args):
    """Run one CUDA route of the mLSTM scan into fresh outputs."""
    q, C0, n0, m0 = args[0], args[5], args[6], args[7]
    h, C, n, m = (torch.empty_like(x) for x in (q, C0, n0, m0))
    if fn is mlstm_kernel.mlstm_scan_chunkwise_cuda:
        B, H, S, _ = q.shape
        rec = torch.empty(mlstm_kernel.record_numel(B * H, S),
                          device="cuda")
        fn(*args, rec, h, C, n, m)
    else:
        fn(*args, h, C, n, m)
    return h, C, n, m


def check_mlstm_against_plain(label, got, want) -> float:
    """h, C, n within MLSTM_TOL and m bitwise; returns the largest error."""
    torch.cuda.synchronize()
    worst = 0.0
    for name, g, w in zip(("h", "C", "n", "m"), got, want):
        if g.shape != w.shape or g.dtype != torch.float32:
            fail(f"mlstm_scan {label} {name}: {tuple(g.shape)} {g.dtype}, "
                 f"plain {tuple(w.shape)} {w.dtype}")
        if not torch.isfinite(g).all():
            fail(f"mlstm_scan {label} {name}: non-finite kernel output")
        err = float((g - w).abs().max())
        worst = max(worst, err)
        if name == "m" and not torch.equal(g, w):
            fail(f"mlstm_scan {label}: m is not bitwise the plain version's")
        if not torch.allclose(g, w, **MLSTM_TOL):
            fail(f"mlstm_scan {label} {name}: max_abs_err {err:.3e} beyond "
                 f"rtol={MLSTM_TOL['rtol']} atol={MLSTM_TOL['atol']}")
    print(f"  {label}: h, C, n max_abs_err={worst:.3e} "
          f"(rtol={MLSTM_TOL['rtol']}, atol={MLSTM_TOL['atol']}), m bitwise "
          "equal")
    return worst


def check_mlstm_controls(label, h, args, want_h) -> float:
    """The kernel's h against plain versions with a chunkwise slip: the
    carried state entering chunk 1 one step late, the decay mask reaching
    s = t + 1, and the carried state's decay formed with m_{t-1} (a slip
    of a few percent in most rows). Every row (b, h, t) that a control
    moves beyond MLSTM_TOL (the plain version fails the limit against it
    there) must fail the limit against the kernel too, or the run fails.
    A row that a slip moves by less than the limit is one no check at
    this limit can see: those are counted and printed. Returns the least
    ratio over the rows each control moves beyond the limit."""
    L = mlstm_kernel.CHUNK
    tol = MLSTM_TOL

    def ratio(got, w):
        return ((got - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())) \
            .amax(-1)

    least = {}
    for name, kw in (("state one step late at step L", dict(late_at=L)),
                     ("mask includes s = t+1", dict(peek=True)),
                     ("g_t with m_{t-1}", dict(stale_m=True))):
        w = mlstm_control_ref(*args, **kw)
        per_row = ratio(h, w)
        changed = (w != want_h).any(-1)
        seen = ratio(want_h, w) > 1
        if not bool(seen.any()):
            fail(f"mlstm_scan {label}: the control {name} moves no row "
                 "beyond the limit")
        least[name] = float(per_row[seen].min())
        print(f"  {label} control {name}: changes {int(changed.sum())} "
              f"rows, {int(seen.sum())} beyond the limit; there the kernel "
              f"fails it by at least {least[name]:.2f}x (median "
              f"{float(per_row[seen].median()):.1f}x); least over every "
              f"row it changes {float(per_row[changed].min()):.2f}x")
        if least[name] <= 1:
            fail(f"mlstm_scan {label}: the control {name} passes MLSTM_TOL "
                 "in a row it moves beyond the limit")
    return min(least.values())


def check_mlstm(gen):
    """Both routes against the plain version: the wrapper's choice at each
    S (chunkwise from CHUNKWISE_MIN_S on, recurrent below), the chunk's
    edges, a fresh and a non-zero state, and each route forced at a shape
    the wrapper sends to the other; controls that the chunkwise form must
    fail; device times warm and with a cold L2 at S=600 and S=64 (B=1) and
    S=1 (B=8)."""
    print("[kernels] mlstm_scan")
    H, D, L = 4, 1024, mlstm_kernel.CHUNK
    errs, timing = {}, {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush_ms = device_ms(flush.zero_)
    for B, S, fresh in ((1, 600, False), (1, 600, True), (1, 64, False),
                        (1, 37, False), (1, L - 1, False), (1, L, True),
                        (1, L + 1, False), (1, 2 * L + 3, False),
                        (8, 1, False), (8, 1, True)):
        args = mlstm_inputs(gen, B, H, S, D, fresh)
        want = mlstm_scan_ref(*args)
        label = (f"B={B} H={H} S={S} D={D} {mlstm_ops.route(S)}, "
                 f"{'fresh' if fresh else 'non-zero'} state")
        got = mlstm_scan(*args)
        errs[(B, S, fresh)] = check_mlstm_against_plain(label, got, want)
        other = (mlstm_kernel.mlstm_scan_cuda
                 if mlstm_ops.route(S) == "chunkwise"
                 else mlstm_kernel.mlstm_scan_chunkwise_cuda)
        if S in (37, 1) and not fresh:
            check_mlstm_against_plain(
                label.replace(mlstm_ops.route(S), f"{other.__name__} forced"),
                _mlstm_outs(other, args), want)
        if S == 600 and not fresh:
            control = check_mlstm_controls(label, got[0], args, want[0])
        if S in (600, 64, 1) and not fresh:
            def run():
                return mlstm_scan(*args)
            # the chunkwise route launches a prep and a scan kernel
            n_k = 2 if mlstm_ops.route(S) == "chunkwise" else 1
            ms, dev = timed(run, "mlstm_", per_call=n_k)
            cold = device_ms(lambda: (flush.zero_(), run()), "mlstm_",
                             per_call=n_k)
            split = ({k: device_ms(run, k) for k in ("mlstm_chunk_prep",
                                                     "mlstm_chunk_scan")}
                     if mlstm_ops.route(S) == "chunkwise" else {})
            plain = time_ms(lambda: mlstm_scan_ref(*args), iters=3, warmup=1)
            b, by = work_bound(mlstm_scan_work, *args)
            timing[(B, S)] = dict(ms=ms, device_ms=dev, cold_device_ms=cold,
                                  plain_ms=plain, bound_ms=b, bound_by=by,
                                  route=mlstm_ops.route(S),
                                  **{f"{k}_device_ms": v
                                     for k, v in split.items()})
            print(f"  B={B} S={S} ({mlstm_ops.route(S)}): {ms:.4f} ms "
                  f"events, {dev:.4f} ms device, {cold:.4f} ms device with "
                  f"a cold L2 (a 64 MB write between calls, itself "
                  f"{flush_ms:.4f} ms, not counted); " +
                  "".join(f"{k} {v:.4f} ms; " for k, v in split.items()) +
                  f"plain {plain:.3f} ms; bound {b:.4f} ms ({by}), the "
                  f"kernels at {b / dev:.1%} of it")
        del args, got, want
        torch.cuda.empty_cache()
    t = timing[(1, 600)]
    return dict(name="mlstm_scan", source=mlstm_kernel.SOURCE,
                replaces=mlstm_kernel.REPLACES,
                max_abs_err=errs[(1, 600, False)], library_ms=None, **t,
                control_worst_ratio=control,
                s64=dict(timing[(1, 64)], shape="B=1 H=4 S=64 D=1024 f32"),
                decode=dict(timing[(8, 1)], shape="B=8 H=4 S=1 D=1024 f32"),
                shape=f"B=1 H={H} S=600 D={D} f32")


def check_moe_gemm_controls(name: str, got, x, wg, wu, wd, want) -> float:
    """Hold the kernel's bf16 output against plain versions with one slip
    each: the gate and up products without their first 16-wide slice of
    M (one k16 step of wgmma), the down product without its last 64-deep
    tile of H, expert 0 with expert 1's weights. Every row (e, c) that a
    control changes must fail GEMM_TOL in it, or the check could not see
    such a fault in that row. Returns the least of the rows' worst
    ratios."""
    tol = GEMM_TOL[torch.bfloat16]
    g = got.float()
    xd = x.clone()
    xd[..., :16] = 0
    wdd = wd.clone()
    wdd[:, -64:] = 0
    swap = [w.clone() for w in (wg, wu, wd)]
    for w, orig in zip(swap, (wg, wu, wd)):
        w[0] = orig[1]
    controls = {"gate/up M[0:16] dropped": (xd, wg, wu, wd),
                "down H cut by one tile": (x, wg, wu, wdd),
                "expert 0 with expert 1's weights": (x, *swap)}
    ratios = {}
    for label, args in controls.items():
        w = moe_gemm_ref(*args)
        rows = (w != want).any(-1)
        wf = w.float()
        per_row = ((g - wf).abs() / (tol["atol"] + tol["rtol"] * wf.abs())) \
            .amax(-1)
        if not bool(rows.any()):
            fail(f"{name}: the control {label} changes no row")
        ratios[label] = float(per_row[rows].min())
        del w, wf, per_row
    print(f"  {name} controls (least over the rows each changes): " +
          ", ".join(f"{label} {r:.1f}x the limit"
                    for label, r in ratios.items()))
    for label, r in ratios.items():
        if r <= 1:
            fail(f"{name}: the control {label} passes GEMM_TOL in a row: "
                 "the check cannot see that fault there")
    return min(ratios.values())


def check_moe_gemm(gen):
    """Every capacity through the wrapper in f32 and bf16 against the plain
    version (bf16 at GEMM_TOL, beside controls at C=1 and C=683); the bf16
    kernel's device time at each decode-sized C (where it should stay at
    the weights' bytes bound), and the serving path's two regimes timed:
    C=683 (8192 prefill tokens) and C=1 (decode)."""
    print("[kernels] moe_gemm")
    E, M, H = 60, 2048, 1408
    errs, timing, small, controls = {}, {}, {}, {}
    for C in (1, 2, 4, 8, 37, 683):
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(gen, (E, C, M), dtype)
            wg = randn(gen, (E, M, H), dtype, M ** -0.5)
            wu = randn(gen, (E, M, H), dtype, M ** -0.5)
            wd = randn(gen, (E, H, M), dtype, H ** -0.5)
            want = moe_gemm_ref(x, wg, wu, wd)
            name = f"E={E} C={C} M={M} H={H} {dtype}"
            got = moe_gemm(x, wg, wu, wd)
            errs[(C, dtype)] = compare(name, got, want, dtype,
                                       GEMM_TOL[dtype])
            if dtype == torch.bfloat16 and C in (1, 683):
                controls[C] = check_moe_gemm_controls(name, got, x, wg, wu,
                                                      wd, want)
            del got
            if dtype == torch.bfloat16 and C <= 8:
                small[C] = device_ms(lambda: moe_gemm(x, wg, wu, wd),
                                     "moe_gemm_")
                print(f"  C={C} bf16: {small[C]:.4f} ms on the device")
            if dtype == torch.bfloat16 and C in (1, 683):
                ms, dev = timed(lambda: moe_gemm(x, wg, wu, wd), "moe_gemm_")
                plain, plain_dev = timed(
                    lambda: moe_gemm_ref(x, wg, wu, wd), iters=5)
                lib, lib_dev = timed(lambda: torch.bmm(
                    F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd))
                flops, nbytes = moe_gemm_work(x, wg, wu, wd)
                b, by = bound_ms(nbytes, flops, dtype)
                timing[C] = dict(
                    ms=ms, device_ms=dev, plain_ms=plain,
                    plain_device_ms=plain_dev, library_ms=lib,
                    library_device_ms=lib_dev, bound_ms=b, bound_by=by,
                    tflops=flops / dev / 1e9, tbps=nbytes / dev / 1e9)
                print(f"  C={C} bf16: kernel {ms:.3f} ms events, "
                      f"{dev:.4f} ms device ({flops / dev / 1e9:.1f} TFLOP/s"
                      f", {nbytes / dev / 1e9:.3f} TB/s); plain {plain:.3f} /"
                      f" {plain_dev:.3f} ms; torch.bmm x3 {lib:.3f} / "
                      f"{lib_dev:.4f} ms; bound {b:.3f} ms ({by})")
            del x, wg, wu, wd, want
            torch.cuda.empty_cache()
    return dict(name="moe_gemm", source=gemm_kernel.SOURCE,
                replaces=gemm_kernel.REPLACES,
                max_abs_err=errs[(683, torch.bfloat16)], **timing[683],
                shape=f"E={E} C=683 M={M} H={H} bf16",
                decode=dict(timing[1], shape=f"E={E} C=1 M={M} H={H} bf16"),
                small_c_device_ms={f"C={c}": v for c, v in small.items()},
                control_worst_ratio={f"C={c}": v
                                     for c, v in controls.items()})


def check_flash_controls(name: str, got, q, k, v, window=None) -> float:
    """Hold the kernel's bf16 output against plain versions whose mask is
    off by one: every query one position later (the causal diagonal and
    the window's start shifted), and, where the window bites (S above
    it), the window one key shorter and longer. Each must fail FLASH_TOL,
    or the check could not see such a fault. Returns the least of their
    worst ratios."""
    tol = FLASH_TOL[torch.bfloat16]
    g = got.float()
    shifted = flash_attention_ref(torch.roll(q, 1, dims=1), k, v,
                                  window=window)
    wrongs = {"position+1": (g[:, :-1], shifted[:, 1:])}
    if window is not None and q.shape[1] > window:
        for d in (-1, 1):
            wrongs[f"window{d:+d}"] = (
                g, flash_attention_ref(q, k, v, window=window + d))
    ratios = {label: _worst(a, b.float(), tol)
              for label, (a, b) in wrongs.items()}
    print(f"  {name} controls: " + ", ".join(
        f"{label} {r:.1f}x the limit" for label, r in ratios.items()))
    for label, r in ratios.items():
        if r <= 1:
            fail(f"{name}: the control {label} passes FLASH_TOL: the check "
                 "cannot see a mask off by one")
    return min(ratios.values())


def check_flash_head_dims(gen, window=None):
    """Every head dim the kernel takes, in bf16, at a small S and at a
    ragged S (GQA, then MQA), with or without a window."""
    for D in flash_kernel.HEAD_DIMS:
        for B, S, H, Kv in ((2, 128, 4, 2), (1, 333, 6, 1)):
            q = randn(gen, (B, S, H, D), torch.bfloat16)
            k = randn(gen, (B, S, Kv, D), torch.bfloat16)
            v = randn(gen, (B, S, Kv, D), torch.bfloat16)
            name = f"B={B} S={S} H={H} Kv={Kv} D={D} window={window} bf16"
            got = flash_attention(q, k, v, window=window)
            compare(name, got, flash_attention_ref(q, k, v, window=window),
                    torch.bfloat16, FLASH_TOL[torch.bfloat16])
            check_flash_controls(name, got, q, k, v, window)


def check_flash(gen):
    print("[kernels] flash_attention")
    H, Kv, D = 16, 16, 128
    errs = {}
    timing = None
    for B, S in ((8, 64), (2, 1024), (2, 600)):
        for dtype in (torch.float32, torch.bfloat16):
            q = randn(gen, (B, S, H, D), dtype)
            k = randn(gen, (B, S, Kv, D), dtype)
            v = randn(gen, (B, S, Kv, D), dtype)
            name = f"B={B} S={S} H={H} Kv={Kv} D={D} {dtype}"
            got = flash_attention(q, k, v)
            errs[(S, dtype)] = compare(name, got,
                                       flash_attention_ref(q, k, v), dtype,
                                       FLASH_TOL[dtype])
            if dtype == torch.bfloat16:
                check_flash_controls(name, got, q, k, v)
            if S == 1024 and dtype == torch.bfloat16:
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                ms, dev = timed(lambda: flash_attention(q, k, v),
                                "flash_attention_")
                plain, plain_dev = timed(lambda: flash_attention_ref(q, k, v))
                lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
                flops, nbytes = flash_attention_work(q, k, v)
                b, by = bound_ms(nbytes, flops, dtype)
                timing = dict(ms=ms, device_ms=dev, plain_ms=plain,
                              plain_device_ms=plain_dev, library_ms=lib,
                              library_device_ms=lib_dev, bound_ms=b,
                              bound_by=by, tflops=flops / dev / 1e9)
                print(f"  B={B} S={S} bf16: kernel {ms:.4f} ms events, "
                      f"{dev:.4f} ms device ({flops / dev / 1e9:.1f} "
                      f"TFLOP/s); plain {plain:.3f} / {plain_dev:.3f} ms; "
                      f"F.scaled_dot_product_attention {lib:.4f} / "
                      f"{lib_dev:.4f} ms; bound {b:.4f} ms ({by})")
    # GQA with a sliding window (the kernel's window bound), ragged S
    q = randn(gen, (1, 600, 12, 128), torch.float32)
    k = randn(gen, (1, 600, 2, 128), torch.float32)
    v = randn(gen, (1, 600, 2, 128), torch.float32)
    compare("GQA g=6 S=600 window=128 f32",
            flash_attention(q, k, v, window=128),
            flash_attention_ref(q, k, v, window=128), torch.float32,
            FLASH_TOL[torch.float32])
    del q, k, v
    check_flash_head_dims(gen)
    hybrid = check_flash_local(gen)
    return dict(name="flash_attention", source=flash_kernel.SOURCE,
                replaces=flash_kernel.REPLACES,
                max_abs_err=errs[(1024, torch.bfloat16)], **timing,
                shape=f"B=2 S=1024 H={H} Kv={Kv} D={D} causal bf16",
                hybrid=hybrid)


def check_flash_local(gen):
    """The hybrid path's local-attention prefill: MQA at D=256 with a
    2048-key window, at a prompt longer than the window; then every head
    dim with a window that the small and ragged S exceed."""
    B, S, H, Kv, D, win = 1, 3000, 16, 1, 256, 2048
    shape = f"B={B} S={S} H={H} Kv={Kv} D={D} window={win}"
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (B, S, H, D), dtype)
        k = randn(gen, (B, S, Kv, D), dtype)
        v = randn(gen, (B, S, Kv, D), dtype)
        got = flash_attention(q, k, v, window=win)
        errs[dtype] = compare(f"{shape} {dtype}", got,
                              flash_attention_ref(q, k, v, window=win),
                              dtype, FLASH_TOL[dtype])
        if dtype == torch.bfloat16:
            control = check_flash_controls(f"{shape} {dtype}", got, q, k, v,
                                           win)
        del q, k, v, got
        torch.cuda.empty_cache()
    check_flash_head_dims(gen, window=100)
    dtype = torch.bfloat16
    q = randn(gen, (B, S, H, D), dtype)
    k = randn(gen, (B, S, Kv, D), dtype)
    v = randn(gen, (B, S, Kv, D), dtype)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).expand(B, H, S, D).contiguous()
    vt = v.transpose(1, 2).expand(B, H, S, D).contiguous()
    pos = torch.arange(S, device="cuda")
    diff = pos[:, None] - pos[None, :]
    mask = (diff >= 0) & (diff < win)
    ms, dev = timed(lambda: flash_attention(q, k, v, window=win),
                    "flash_attention_")
    plain, plain_dev = timed(
        lambda: flash_attention_ref(q, k, v, window=win), iters=3)
    lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask))
    flops, nbytes = flash_attention_work(q, k, v, True, win)
    b, by = bound_ms(nbytes, flops, dtype)
    print(f"  {shape} bf16: kernel {ms:.3f} ms events, {dev:.4f} ms device "
          f"({flops / dev / 1e9:.1f} TFLOP/s); plain {plain:.3f} / "
          f"{plain_dev:.3f} ms; F.scaled_dot_product_attention (window "
          f"mask) {lib:.3f} / {lib_dev:.4f} ms; bound {b:.4f} ms ({by})")
    return dict(ms=ms, device_ms=dev, plain_ms=plain,
                plain_device_ms=plain_dev, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=b, bound_by=by,
                tflops=flops / dev / 1e9, max_abs_err=errs[dtype],
                max_abs_err_f32=errs[torch.float32],
                control_worst_ratio=control, shape=f"{shape} bf16")


# RG-LRU: the kernel's step rounds as the plain version's separate
# multiply and add do, so f32 must be bitwise equal (a failing check);
# bf16 inputs are held to the reference's kernel tolerance
# (tests/test_kernels.py:86-89)
RGLRU_TOL = dict(rtol=1e-5, atol=1e-5)


def check_rg_lru(gen):
    """f32 bitwise and bf16 within RGLRU_TOL at decode (B=8, S=1, the short
    kernel), the hybrid prefill shapes (B=1, W=4096, S=600 and S=3000), a
    ragged one (3, 37, 1000), a short prompt (2, 20, 1000: the short
    kernel, S not a multiple of its unroll) and two that fill only part of
    the tile kernel's ring (one and two tiles, the last one partial); f32
    device times warm and with a cold L2 (a 64 MB write between calls: a
    3000-token prefill moves three times the L2) at the first three."""
    print("[kernels] rg_lru_scan")
    errs, timing = {}, {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    flush_ms = device_ms(flush.zero_)
    for B, S, W in ((8, 1, 4096), (1, 600, 4096), (1, 3000, 4096),
                    (3, 37, 1000), (2, 20, 1000), (1, 100, 4096),
                    (2, 200, 1000)):
        for dtype in (torch.float32, torch.bfloat16):
            a = (0.8 + 0.199 * torch.rand((B, S, W), generator=gen,
                                          device="cuda")).to(dtype)
            b = randn(gen, (B, S, W), dtype, 0.1)
            h0 = randn(gen, (B, W), torch.float32)
            got = rg_lru_scan(a, b, h0)
            want = rg_lru_scan_ref(a, b, h0)
            torch.cuda.synchronize()
            err, same = 0.0, True
            for name, g, w in zip(("h", "h_last"), got, want):
                if g.shape != w.shape or g.dtype != torch.float32:
                    fail(f"rg_lru_scan {name}: {tuple(g.shape)} {g.dtype}, "
                         f"plain {tuple(w.shape)} {w.dtype}")
                if not torch.isfinite(g).all():
                    fail(f"rg_lru_scan {name}: non-finite kernel output")
                err = max(err, float((g - w).abs().max()))
                same = same and torch.equal(g, w)
                if not torch.allclose(g, w, **RGLRU_TOL):
                    fail(f"rg_lru_scan B={B} S={S} W={W} {dtype} {name}: "
                         f"max_abs_err {err:.3e}")
            if dtype == torch.float32 and not same:
                fail(f"rg_lru_scan B={B} S={S} W={W} f32: not bitwise equal "
                     f"to the plain version (max_abs_err {err:.3e})")
            errs[(B, S, dtype)] = err
            print(f"  B={B} S={S} W={W} {dtype}, non-zero h0: h, h_last "
                  f"max_abs_err={err:.3e} (rtol={RGLRU_TOL['rtol']}, "
                  f"atol={RGLRU_TOL['atol']}) "
                  f"{'bitwise equal' if same else 'ok, not bitwise'}")
            if dtype == torch.float32 and (B, S) in ((8, 1), (1, 600),
                                                     (1, 3000)):
                def run():
                    return rg_lru_scan(a, b, h0)
                ms, dev = timed(run, "rg_lru_scan")
                cold = device_ms(lambda: (flush.zero_(), run()),
                                 "rg_lru_scan")
                plain = time_ms(lambda: rg_lru_scan_ref(a, b, h0),
                                iters=3, warmup=1)
                b_ms, by = work_bound(rg_lru_scan_work, a, b, h0)
                timing[(B, S)] = dict(ms=ms, device_ms=dev,
                                      cold_device_ms=cold, plain_ms=plain,
                                      bound_ms=b_ms, bound_by=by)
                print(f"  B={B} S={S} W={W} f32: kernel {ms:.4f} ms (CUDA "
                      f"events, with the wrapper's host path), {dev:.5f} ms "
                      f"on the device, {cold:.5f} ms with a cold L2 (the "
                      f"64 MB write, {flush_ms:.4f} ms, not counted); plain "
                      f"{plain:.3f} ms, bound {b_ms:.5f} ms ({by}), the "
                      f"kernel at {b_ms / cold:.1%} of it cold")
            del a, b, h0, got, want
            torch.cuda.empty_cache()
    print("  f32 bitwise equal to the plain version at every shape")
    return dict(name="rg_lru_scan", source=rglru_kernel.SOURCE,
                replaces=rglru_kernel.REPLACES,
                max_abs_err=errs[(1, 3000, torch.float32)], library_ms=None,
                bitwise_f32=True, **timing[(1, 3000)],
                s600=dict(timing[(1, 600)], shape="B=1 S=600 W=4096 f32"),
                decode=dict(timing[(8, 1)], shape="B=8 S=1 W=4096 f32"),
                shape="B=1 S=3000 W=4096 f32")


# ---------------------------------------------------------------------------
# the scans' backwards (the port's own kernels: no TPU function)
# ---------------------------------------------------------------------------

#: the scans' backwards against their plain versions, f32, relative L2 of
#: each gradient. The RG-LRU backward takes the plain version's rounded
#: steps, so it must also be bitwise equal; the mLSTM backward sums in
#: another order (chunks, 3xTF32 products in 32-deep slices): the
#: step-sequential kernel this replaced read 1.3e-7 to 1.4e-6, 7.6e-7 at
#: the train shape; the chunkwise one 6.5e-7 to 1.6e-6, 1.0e-6 to 1.2e-6
#: at the train shape (NVIDIA H100 80GB HBM3, 700 W), so the CPU tests'
#: 1e-5 holds here too. Summed straight into the tensor cores' truncating
#: accumulator, with no slices, it read 1.05e-5 to 1.08e-5 (PERF.md section
#: 6 row 8)
SCAN_BWD_TOL = 1e-5
#: the reference code the backwards take the place of (neither has a TPU
#: kernel: the reference differentiates these with jax.grad)
BWD_REPLACES = {
    "rg_lru_scan_backward": "none (no TPU function): jax.grad of "
                            "src/repro/models/rglru.py:61-98",
    "mlstm_scan_backward": "none (no TPU function): jax.grad of "
                           "src/repro/models/ssm.py:89-128"}


def check_grads_against(name: str, label: str, got, want, names,
                        bitwise: bool = False) -> float:
    """Each gradient finite, of the plain version's shape and dtype, within
    SCAN_BWD_TOL relative L2 (and bitwise equal with ``bitwise``); returns
    the worst relative L2."""
    torch.cuda.synchronize()
    worst, same = 0.0, True
    for n, g, w in zip(names, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{name} {label} {n}: {tuple(g.shape)} {g.dtype}, plain "
                 f"{tuple(w.shape)} {w.dtype}")
        if not torch.isfinite(g).all():
            fail(f"{name} {label} {n}: non-finite kernel output")
        err = rel_l2(g, w)
        worst = max(worst, err)
        same = same and torch.equal(g, w)
        if err > SCAN_BWD_TOL:
            fail(f"{name} {label} {n}: relative L2 {err:.3e} beyond "
                 f"{SCAN_BWD_TOL}")
    if bitwise and not same:
        fail(f"{name} {label}: not bitwise equal to the plain version")
    print(f"  {label}: worst relative L2 {worst:.3e} over "
          f"{', '.join(names)} (limit {SCAN_BWD_TOL}); "
          f"{'bitwise equal' if same else 'not bitwise'}")
    return worst


def check_control(name: str, label: str, what: str, got, control,
                  which) -> float:
    """A plain backward with one slip (``control``) must miss
    SCAN_BWD_TOL against the kernel in at least one of the gradients
    ``which``; returns the worst ratio to the limit."""
    ratio = max(rel_l2(got[i], control[i]) for i in which) / SCAN_BWD_TOL
    print(f"  {label} control {what}: {ratio:.3g}x the limit")
    if ratio <= 1:
        fail(f"{name} {label}: the control {what} passes SCAN_BWD_TOL")
    return ratio


def check_rg_lru_backward(gen):
    """The RG-LRU backward against its plain version in f32 at the
    recurrentgemma-9b train shape (B = 4, S = 512, W = 4096), a ragged
    shape and S = 1, gradients on h and h_last; bitwise; a control whose
    dh is shifted by one step; device times (warm and cold L2) at the
    train shape."""
    print("[kernels] rg_lru_scan_backward")
    name, names = "rg_lru_scan_backward", ("da", "db", "dh0")
    errs, timing, controls = {}, {}, {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for B, S, W in ((4, 512, 4096), (3, 37, 1000), (2, 1, 8)):
        a = 0.8 + 0.199 * torch.rand((B, S, W), generator=gen, device="cuda")
        b = randn(gen, (B, S, W), torch.float32, 0.1)
        h0 = randn(gen, (B, W), torch.float32)
        hs, _ = rg_lru_scan(a, b, h0)
        dhs = randn(gen, (B, S, W), torch.float32)
        dl = randn(gen, (B, W), torch.float32)
        label = f"B={B} S={S} W={W} f32"
        got = rg_lru_scan_backward(a, h0, hs, dhs, dl)
        want = rg_lru_scan_backward_ref(a, h0, hs, dhs, dl)
        errs[(B, S)] = check_grads_against(name, label, got, want, names,
                                           bitwise=True)
        if S > 1:
            controls[label] = check_control(
                name, label, "dh shifted by one step", got,
                rg_lru_scan_backward_ref(a, h0, hs, dhs.roll(1, dims=1),
                                         dl), range(3))
        if (B, S) == (4, 512):
            def run():
                return rg_lru_scan_backward(a, h0, hs, dhs, dl)
            b_ms, by = work_bound(rg_lru_scan_backward_work, a, h0, hs, dhs,
                                  dl)
            ms, dev = timed(run, name, bound=b_ms)
            cold = device_ms(lambda: (flush.zero_(), run()), name)
            plain = time_ms(lambda: rg_lru_scan_backward_ref(
                a, h0, hs, dhs, dl), iters=3, warmup=1)
            timing = dict(ms=ms, device_ms=dev, cold_device_ms=cold,
                          plain_ms=plain, bound_ms=b_ms, bound_by=by)
            print(f"  {label}: kernel {ms:.4f} ms events, {dev:.4f} ms "
                  f"device, {cold:.4f} ms cold; plain {plain:.3f} ms; "
                  f"bound {b_ms:.4f} ms ({by}), the kernel at "
                  f"{b_ms / dev:.1%} of it")
        del a, b, h0, hs, dhs, dl, got, want
        torch.cuda.empty_cache()
    return dict(name=name, source=rglru_kernel.BACKWARD_SOURCE,
                replaces=BWD_REPLACES[name], max_abs_err=errs[(4, 512)],
                error="relative L2", bitwise_f32=True, library_ms=None,
                controls=controls, shape="B=4 S=512 W=4096 f32", **timing)


#: the step-sequential mLSTM backward that the chunkwise one replaced, and
#: the xlstm-1.3b train step around it, as PERF.md (section 6 row 8 and
#: section 5) records them on an NVIDIA H100 80GB HBM3 at 700 W: printed
#: beside this run's readings under that label, never reported as this
#: run's
STEPWISE_MLSTM_BWD = dict(device_ms=25.5335, event_ms=25.827,
                          function_ms=25.680, scratch_gib=3.55,
                          xlstm_step_ms=(1225.1, 1416.4),
                          xlstm_peak_gb=20.00)
STEPWISE_LABEL = "the step-sequential backward, as PERF.md records it"


def mlstm_bwd_bound(*args) -> tuple:
    """``bound_ms`` of the mLSTM backward: the bytes its wrapper counts
    (``mlstm_scan_backward_work``: each operand read once, each gradient
    written once) and the operations the chunkwise algebra needs
    (``kernel.backward_flops``, not the work count's 12 D^2 a step of the
    step-by-step form) priced at the f32-accurate tensor rate (3xTF32)."""
    _, nbytes = mlstm_scan_backward_work(*args)
    B, H, S, D = args[0].shape
    flops = mlstm_kernel.backward_flops(B * H, S, D)
    return bound_ms(nbytes, flops, torch.float32, peak=PEAK_FLOPS_3XTF32)


def check_mlstm_backward(gen):
    """The mLSTM backward against its plain version in f32 (relative L2
    of each of the eight gradients, gradients on h and the final C, n,
    m): at the train_recurrent path's shape (xlstm-1.3b: B = 4, H = 4,
    S = 512, D = 1024; the plain version keeps 513 states of 64 MiB, 32
    GiB) from a random state with the clamp off and on and from the fresh
    state (m0 = -1e30, C0 = n0 = 0) the train path passes, at B = 1, S =
    64, the clamp off and on (q scaled by 0.02: the denominator held at
    1), at D = 48, S = 37 (a D no tile divides, an S no chunk divides)
    and at S = 1; two calls bitwise equal (no atomics); controls (S > 1):
    dh shifted by one step, with the clamp on a backward that holds m
    constant (``drop_dm``), and the chunkwise mirror with its gate terms
    formed without dC (``drop_seed``), each of which must miss the limit.
    Device times (warm and cold L2) at the train shape from the random
    state (clamp off; the plain version's is the shifted control's call,
    one call with CUDA events), the backward's scratch and its peak, and
    at B = 1, S = 64."""
    print("[kernels] mlstm_scan_backward")
    name = "mlstm_scan_backward"
    names = ("dq", "dk", "dv", "di", "dlf", "dC0", "dn0", "dm0")
    errs, timing, controls = {}, {}, {}
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for B, H, S, D, qs, fresh in (
            (4, 4, 512, 1024, 1.0, False), (4, 4, 512, 1024, 0.02, False),
            (4, 4, 512, 1024, 1.0, True), (1, 4, 64, 1024, 1.0, False),
            (1, 4, 64, 1024, 0.02, False), (2, 2, 37, 48, 1.0, False),
            (1, 1, 1, 64, 1.0, False)):
        args = list(mlstm_inputs(gen, B, H, S, D, fresh=fresh))
        args[0] = args[0] * qs
        h = mlstm_scan(*args)[0]
        grads = (randn(gen, (B, H, S, D), torch.float32),
                 randn(gen, (B, H, D, D), torch.float32),
                 randn(gen, (B, H, D), torch.float32),
                 randn(gen, (B, H), torch.float32))
        label = f"B={B} H={H} S={S} D={D} q x{qs}" + (" fresh" if fresh
                                                     else "")
        got = mlstm_scan_backward(*args, h, *grads)
        again = mlstm_scan_backward(*args, h, *grads)
        want = mlstm_scan_backward_ref(*args, *grads)
        errs[label] = check_grads_against(name, label, got, want, names)
        del want
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            fail(f"{name} {label}: two calls differ")
        print(f"  {label}: two calls bitwise equal")
        del again
        if S > 1:
            shifted, plain = event_ms_once(lambda: mlstm_scan_backward_ref(
                *args, grads[0].roll(1, dims=2), *grads[1:]))
            controls[f"{label} dh shifted"] = check_control(
                name, label, "dh shifted by one step", got, shifted,
                range(8))
            del shifted
        if qs < 1:
            controls[f"{label} m held constant"] = check_control(
                name, label, "m held constant (clamp on)", got,
                mlstm_scan_backward_ref(*args, *grads, drop_dm=True),
                (3, 4, 7))
        if S > 1:   # at S = 1, where lf + m0 wins the max, f' is 1 and
            # dlf, di and dm0 do not depend on df' (read 0.278x the limit)
            controls[f"{label} gate terms without dC"] = check_control(
                name, label, "gate terms without dC (drop_seed)", got,
                mlstm_scan_backward_chunkwise_ref(
                    *args, *grads, chunk=mlstm_kernel.BACKWARD_CHUNK,
                    drop_seed=True), (3, 4, 7))
        if D == 1024 and qs == 1.0 and not fresh:
            def run():
                return mlstm_scan_backward(*args, h, *grads)
            b_ms, by = mlstm_bwd_bound(*args, h, *grads)
            kern = {}
            ms, dev = timed(run, "mlstm_bwd_", iters=5, bound=b_ms,
                            by_name=kern)
            cold = device_ms(lambda: (flush.zero_(), run()), "mlstm_bwd_",
                             iters=5, lead=True)
            scratch = mlstm_kernel.backward_scratch_bytes(B * H, S, D)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            timing[(B, S)] = dict(ms=ms, device_ms=dev, cold_device_ms=cold,
                                  plain_ms=plain, bound_ms=b_ms, bound_by=by,
                                  scratch_bytes=scratch,
                                  call_peak_bytes=peak, kernels_ms=kern)
            old = (f"; {STEPWISE_LABEL}: "
                   f"{STEPWISE_MLSTM_BWD['device_ms']} ms device, "
                   f"{STEPWISE_MLSTM_BWD['event_ms']} events, scratch "
                   f"{STEPWISE_MLSTM_BWD['scratch_gib']} GiB"
                   if (B, S) == (4, 512) else "")
            print(f"  {label}: kernels {ms:.4f} ms events, {dev:.4f} ms "
                  f"device, {cold:.4f} cold ({PER_CALL['mlstm_bwd_']} "
                  f"kernels a call); plain {plain:.3f} ms (one call); "
                  f"bound {b_ms:.4f} ms ({by}, products at 3xTF32's "
                  f"{PEAK_FLOPS_3XTF32 / 1e12:.0f} TFLOP/s), the kernels "
                  f"at {b_ms / dev:.1%} of it; scratch {scratch} bytes "
                  f"({scratch / 2**30:.3f} GiB), the call's peak {peak} "
                  f"bytes ({peak / 2**30:.3f} GiB){old}")
            print(f"  {label}: device ms a call by kernel: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in kern.items()))
        del args, h, grads, got
        torch.cuda.empty_cache()
    train = "B=4 H=4 S=512 D=1024"
    return dict(name=name, source=mlstm_kernel.BACKWARD_SOURCE,
                replaces=BWD_REPLACES[name],
                max_abs_err=max(errs[f"{train} q x1.0"],
                                errs[f"{train} q x0.02"],
                                errs[f"{train} q x1.0 fresh"]),
                error="relative L2", library_ms=None, controls=controls,
                bitwise_repeat=True,
                **timing[(4, 512)], shape=f"{train} f32 (train_recurrent)",
                s64=dict(timing[(1, 64)], shape="B=1 H=4 S=64 D=1024 f32"))


def event_ms_once(fn) -> tuple:
    """(``fn()``, its CUDA-event ms): one call, for a plain version too
    slow to call again."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


# ---------------------------------------------------------------------------
# kernelcheck's ledger states on the card
# ---------------------------------------------------------------------------

def _poisoned(pool, live_rows):
    """A copy of ``pool`` (rows of [Kv, D] along a flat first axis) with
    NaN in every row not in ``live_rows``."""
    flat = pool.reshape(-1, *pool.shape[-2:]).clone()
    dead = torch.ones(flat.shape[0], dtype=torch.bool)
    dead[sorted(live_rows)] = False
    flat[dead.to(flat.device)] = float("nan")
    return flat.reshape(pool.shape)


def phase_kernelcheck_states(gen) -> dict:
    """The decode kernels over ``analysis.kernelcheck``'s boundary states,
    bf16, H = 8, Kv = 2, D = 128: the paged kernel over the port's paging
    ledger (bs 16 and 48: shared prefixes, a full row, decode growth, a
    reset and an untouched slot) and the all-unallocated table, the dense
    kernel over the boundary lengths of caches the chunk does not divide.
    Every pool row that no live position references (page 0 and the dead
    tail of each dense row among them) holds NaN; the output must be
    finite and within DECODE_TOL of the plain version on the clean cache
    (an empty row: zeros). Control: one live position's row poisoned must
    make that batch row non-finite."""
    H, Kv, D, dt = 8, 2, 128, torch.bfloat16
    out = {}

    def check(label, got, want, control_got=None, control_row=None):
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"kernelcheck states {label}: non-finite output over NaN "
                 "rows no live position references")
        worst = _worst(got.float(), want.float(), DECODE_TOL[dt])
        if worst > 1:
            fail(f"kernelcheck states {label}: {worst:.2f} of DECODE_TOL")
        ok = control_got is None or not bool(
            torch.isfinite(control_got[control_row].float()).all())
        if not ok:
            fail(f"kernelcheck states {label}: the control (a live row "
                 "poisoned) stayed finite")
        out[label] = worst
        print(f"  {label}: finite over the NaN rows, {worst:.3f} of "
              f"DECODE_TOL; control {'non-finite' if control_got is not None else 'n/a'}")

    print("[kernelcheck states] the decode kernels over the ledger states")
    for bs in (16, 48):
        kv = kernelcheck.ledger_states(bs)
        tbl, lens = kv._tables, kv.lengths()
        B, n_blocks = tbl.shape
        P = kv.pool.num_blocks
        live = {int(tbl[b, p // bs]) * bs + p % bs
                for b in range(B) for p in range(lens[b])}
        kp = randn(gen, (P, bs, Kv, D), dt)
        vp = randn(gen, (P, bs, Kv, D), dt)
        q = randn(gen, (B, H, D), dt)
        L = torch.tensor(lens, dtype=torch.int32, device="cuda")
        T = torch.from_numpy(tbl.copy()).cuda()
        want = paged_decode_attention_ref(q, kp, vp, L, T)
        got = decode_attention_paged(q, _poisoned(kp, live),
                                     _poisoned(vp, live), L, T)
        b0 = 1                            # a row with live positions
        bad = _poisoned(kp, live - {int(tbl[b0, 0]) * bs})
        ctrl = decode_attention_paged(q, bad, _poisoned(vp, live), L, T)
        check(f"paged ledger bs={bs} lengths {lens}", got, want, ctrl, b0)
    empty = torch.full((3, 4), -1, dtype=torch.int32, device="cuda")
    kp = randn(gen, (8, 16, Kv, D), dt)
    q = randn(gen, (3, H, D), dt)
    L0 = torch.zeros(3, dtype=torch.int32, device="cuda")
    got = decode_attention_paged(q, _poisoned(kp, set()),
                                 _poisoned(kp, set()), L0, empty)
    check("paged all-unallocated", got, torch.zeros_like(got))
    for C in kernelcheck.DENSE_CACHES:
        lens = kernelcheck._boundary_lengths(C)
        B = len(lens)
        live = {b * C + p for b in range(B) for p in range(min(lens[b], C))}
        kc = randn(gen, (B, C, Kv, D), dt)
        vc = randn(gen, (B, C, Kv, D), dt)
        q = randn(gen, (B, H, D), dt)
        L = torch.tensor(lens, dtype=torch.int32, device="cuda")
        want = decode_attention_ref(q, kc, vc, L)
        got = decode_attention(q, _poisoned(kc, live), _poisoned(vc, live),
                               L)
        b0 = B - 1                        # the row past capacity
        ctrl = decode_attention(q, _poisoned(kc, live - {b0 * C}),
                                _poisoned(vc, live), L)
        check(f"dense C={C} lengths {lens}", got, want, ctrl, b0)
    return out


# ---------------------------------------------------------------------------
# phase 3: a small model on the card against the same model on the CPU
# ---------------------------------------------------------------------------

def phase_small() -> dict:
    """Smoke models on the card (kernels) against the same models on the
    CPU (plain versions): prefill and 4 decode steps, rtol = atol = 1e-4
    and greedy tokens equal; then the multimodal and paged smoke models
    and ``launch.quickstart``'s step 5. Returns step 5's launch
    counts."""
    for arch in ("qwen2-moe-a2.7b", "qwen2-1.5b", "deepseek-v2-lite",
                 "xlstm-1.3b", "recurrentgemma-9b", "granite-moe-1b-a400m",
                 "starcoder2-3b", "command-r-35b"):
        cfg = get_smoke_config(arch)
        ctx = ExecutionContext(attn_impl="decode_kernel")
        cpu = build_model(cfg, ctx=ctx, dtype=torch.float32, device="cpu")
        gen = torch.Generator(device="cpu")
        gen.manual_seed(0)
        p_cpu = cpu.init(gen)
        gpu = build_model(cfg, ctx=ctx, dtype=torch.float32, device="cuda")
        p_gpu = params_from_numpy(_to_numpy(p_cpu), "cuda", torch.float32)
        rng = np.random.RandomState(0)
        # a recurrent state would carry the padding of shorter rows; the
        # hybrid and sliding-window prompts are longer than their 64-token
        # window, so their rings roll at prefill and decode past the wrap
        lens, budget = {"ssm": ([16] * 3, 32),
                        "hybrid": ([80] * 3, 128)}.get(cfg.family,
                                                       ([5, 9, 13], 32))
        if is_ring(cfg):
            lens, budget = [80] * 3, 128
        toks = np.zeros((3, max(16, max(lens))), np.int64)
        for i, n in enumerate(lens):
            toks[i, :n] = rng.randint(0, cfg.vocab_size, size=n)
        last = torch.tensor([n - 1 for n in lens])
        worst = 0.0
        outs = {}
        for name, model, params in (("cpu", cpu, p_cpu), ("gpu", gpu, p_gpu)):
            logits, caches = model.prefill(params, torch.from_numpy(toks),
                                           seq_budget=budget,
                                           last_positions=last)
            for c in caches:
                if "index" in c:
                    c["index"] = torch.tensor(lens, dtype=torch.int32,
                                              device=model.device)
            seq = [logits[:, -1].float().cpu()]
            lengths = torch.tensor(lens, dtype=torch.int32) + 1
            for _ in range(4):
                nxt = seq[-1].argmax(-1)[:, None]
                logits, caches = model.decode_step(params, nxt, caches,
                                                   lengths=lengths)
                seq.append(logits[:, -1].float().cpu())
                lengths = lengths + 1
            outs[name] = seq
        for a, b in zip(outs["cpu"], outs["gpu"]):
            worst = max(worst, float((a - b).abs().max()))
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
                fail(f"{arch} smoke: card logits disagree with the CPU")
            if not torch.equal(a.argmax(-1), b.argmax(-1)):
                fail(f"{arch} smoke: greedy tokens disagree with the CPU")
        print(f"[small] {cfg.name}: prefill + 4 decode steps on the card "
              f"match the CPU (max |dlogit| {worst:.2e}, rtol=atol=1e-4), "
              "greedy tokens equal")
    small_multimodal()
    small_paged()
    return small_quickstart()


def small_quickstart() -> dict:
    """``launch.quickstart``'s step 5 on the card: the reduced
    deepseek-v2-lite at f32 without a mesh (the capacity MoE, its experts
    through the f32 SIMT expert GEMM), on weights drawn on the CPU from
    seed 0, against the same call on the CPU (rtol = atol = 1e-4, the
    phase's limit); the expert GEMM launched once per MoE layer and no
    other kernel (``attn_impl="xla"``). Returns the card call's launch
    counts."""
    cfg = get_smoke_config(quickstart.SMOKE_ARCH)
    plan = quickstart.make_planner().plan(seq_len=4096)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    p_cpu = build_model(cfg, dtype=torch.float32, device="cpu").init(gen)
    p_gpu = params_from_numpy(_to_numpy(p_cpu), "cuda", torch.float32)
    kernel_lib.reset_launch_counts()
    card = quickstart.execute(plan, "cuda", params=p_gpu)
    torch.cuda.synchronize()
    counts = kernel_lib.launch_counts()
    cpu = quickstart.execute(plan, "cpu", params=p_cpu)
    want = {"moe_gemm": len(cfg.moe_layer_indices())}
    expect_launches("quickstart step 5", counts, want)
    got = card.logits.float().cpu()
    worst = float((got - cpu.logits).abs().max())
    if not torch.allclose(got, cpu.logits, rtol=1e-4, atol=1e-4):
        fail(f"quickstart step 5: card logits disagree with the CPU "
             f"(max |dlogit| {worst:.2e})")
    if abs(card.aux - cpu.aux) > 1e-4 * max(1.0, abs(cpu.aux)):
        fail(f"quickstart step 5: aux loss {card.aux} on the card, "
             f"{cpu.aux} on the CPU")
    print(f"[small] quickstart step 5 ({cfg.name}, moe_impl "
          f"{card.moe_impl}, plan m_a={plan.m_a} r1={plan.r1} r2={plan.r2} "
          f"{plan.order} unused without a mesh): logits "
          f"{tuple(got.shape)} match the CPU (max |dlogit| {worst:.2e}, "
          f"rtol=atol=1e-4), aux loss {card.aux:.4f} (CPU {cpu.aux:.4f}); "
          f"launches {counts}")
    return counts


def grow_caches(caches, n: int):
    """Each KV cache with ``n`` free positions after its own: the step
    builders' prefill fills caches of the prompt's length (P + S), as the
    reference's does, and the serve steps write after it."""
    return [dict(c, k=F.pad(c["k"], (0, 0, 0, 0, 0, n)),
                 v=F.pad(c["v"], (0, 0, 0, 0, 0, n))) for c in caches]


def small_multimodal() -> None:
    """The vlm and audio smoke models through the step builders on the card
    (kernels) against the CPU (plain versions), f32, one set of weights:
    3 rows of the stub frontend's embeddings and a 12-token prompt,
    ``make_prefill_step`` (audio: encode, then prefill with the memory),
    then 4 ``make_serve_step``s (audio: cross-attention over the memory).
    The prefill logits and the memory must agree at 1e-4, the greedy
    tokens exactly."""
    for arch in ("internvl2-1b", "seamless-m4t-large-v2"):
        cfg = get_smoke_config(arch)
        ctx = ExecutionContext(attn_impl="decode_kernel")
        p_cpu = build_model(cfg, ctx=ctx, dtype=torch.float32,
                            device="cpu").init(generator_for("cpu", 0))
        extra = frontend_inputs(cfg, 3, 12, generator_for("cpu", 1),
                                device="cpu", dtype=torch.float32)
        toks = torch.from_numpy(np.random.RandomState(0).randint(
            0, cfg.vocab_size, size=(3, 12)))
        outs = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, ctx=ctx, dtype=torch.float32,
                                device=dev)
            params = (p_cpu if dev == "cpu" else
                      params_from_numpy(_to_numpy(p_cpu), dev,
                                        torch.float32))
            logits, caches = make_prefill_step(model)(
                params, toks.to(dev), extra.to(dev))
            memory = (model.encode(params, extra.to(dev))
                      if cfg.is_encoder_decoder else None)
            caches = grow_caches(caches, 4)
            nxt = logits[:, -1].argmax(-1)[:, None]
            tokens = [nxt]
            serve_step = make_serve_step(model)
            for _ in range(4):
                nxt, caches = serve_step(params, nxt, caches, memory=memory)
                tokens.append(nxt)
            outs[dev] = (logits.cpu(), torch.cat(tokens, 1).cpu(),
                         None if memory is None else memory.cpu())
        (lc, tc, mc), (lg, tg, mg) = outs["cpu"], outs["cuda"]
        worst = float((lc - lg).abs().max())
        if not torch.allclose(lc, lg, rtol=1e-4, atol=1e-4):
            fail(f"{arch} smoke steps: card prefill logits disagree with "
                 f"the CPU (max {worst:.2e})")
        if mc is not None and not torch.allclose(mc, mg, rtol=1e-4,
                                                 atol=1e-4):
            fail(f"{arch} smoke steps: card memory disagrees with the CPU")
        if not torch.equal(tc, tg):
            fail(f"{arch} smoke steps: card greedy tokens {tg.tolist()} "
                 f"differ from the CPU's {tc.tolist()}")
        print(f"[small] {cfg.name} ({cfg.family}): make_prefill_step + 4 "
              f"make_serve_steps on the card match the CPU (max |dlogit| "
              f"{worst:.2e}{', memory within 1e-4' if mc is not None else ''}"
              "), greedy tokens equal")


def small_paged() -> None:
    """A paged engine (page size 16, GQA g=2) on the card against the same
    engine on the CPU: equal greedy tokens on a shared-prefix trace."""
    cfg = get_smoke_config("qwen2-1.5b")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    p_cpu = build_model(cfg, dtype=torch.float32, device="cpu").init(gen)
    outs = {}
    for dev in ("cpu", "cuda"):
        params = (p_cpu if dev == "cpu" else
                  params_from_numpy(_to_numpy(p_cpu), "cuda", torch.float32))
        eng = ServingEngine(cfg, params=params, num_slots=3, max_context=64,
                            kv_layout="paged", kv_block_size=16,
                            dtype=torch.float32, device=dev)
        rng = np.random.RandomState(2)
        shared = list(rng.randint(0, cfg.vocab_size, size=20))
        reqs = [Request(prompt=shared + list(rng.randint(
            0, cfg.vocab_size, size=n)), max_new_tokens=6)
            for n in (3, 9, 12, 1)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        eng.kv.check_invariants()
        outs[dev] = [r.output for r in reqs]
        hits = eng.paging_stats()["prefix_hit_tokens"]
    if outs["cpu"] != outs["cuda"]:
        fail(f"paged smoke engine: card tokens {outs['cuda']} differ from "
             f"the CPU's {outs['cpu']}")
    print(f"[small] {cfg.name} paged engine (bs=16, {hits} prefix-hit "
          "tokens): greedy tokens on the card equal the CPU's")


def phase_ring() -> None:
    """Teacher-forced decode against prefill at full width across the
    local-attention ring's wrap: recurrentgemma-9b cut to one (rec, rec,
    attn) group, f32 weights drawn on the card. Prefill 2040 tokens, then
    decode 12 more one at a time (positions 2040..2051, so the 2048-slot
    ring wraps at 2048); each step's logits must equal the last logits of
    a prefill of the whole prompt so far, whose prefill at S > 2048 takes
    the roll. The ring and the RG-LRU states after the 12 steps must equal
    those of the 2052-token prefill."""
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=3)
    atol = 1e-3   # f32 through 3 layers at S ~ 2050, summation order only
    t0 = time.perf_counter()
    model = build_model(cfg, ctx=ExecutionContext(attn_impl="decode_kernel"),
                        dtype=torch.float32, device="cuda")
    params = model.init(generator_for(model.device, 0))
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(1, 2060))).cuda()
    _, caches = model.prefill(params, toks[:, :2040], seq_budget=4096)
    worst = 0.0
    for j in range(12):
        logits, caches = model.decode_step(params, toks[:, 2040 + j:2041 + j],
                                           caches)
        want, pre = model.prefill(params, toks[:, :2041 + j],
                                  seq_budget=4096)
        if not torch.isfinite(logits).all():
            fail(f"ring: non-finite logits at decode step {j}")
        err = float((logits - want).abs().max())
        worst = max(worst, err)
        if err > atol:
            fail(f"ring: decode step {j} (position {2040 + j}) logits differ "
                 f"from prefill by {err:.3e} > {atol}")
    state_err = 0.0
    for i, kind in enumerate(model.kinds):
        for name in (("k", "v") if kind == "attn" else ("h", "conv")):
            state_err = max(state_err, float(
                (caches[i][name] - pre[i][name]).abs().max()))
        if kind == "attn" and int(caches[i]["index"]) != 2052:
            fail(f"ring: cache index {int(caches[i]['index'])} != 2052")
    if state_err > atol:
        fail(f"ring: decoded ring/state differs from the rolled prefill's by "
             f"{state_err:.3e} > {atol}")
    print(f"[ring] {cfg.name} at full width, {model.kinds}, f32: 12 decode "
          f"steps across the 2048-slot ring's wrap match prefill (max "
          f"|dlogit| {worst:.2e}, atol={atol}); ring and states after the "
          f"steps match the rolled 2052-token prefill (max diff "
          f"{state_err:.2e}); {time.perf_counter() - t0:.1f} s")
    del model, params, caches, pre
    torch.cuda.empty_cache()


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_numpy(v) for v in tree]
    return tree.numpy()


# ---------------------------------------------------------------------------
# phase 4a: calibrate the cost model on the card
# ---------------------------------------------------------------------------

#: where and at what dtype the calibrate phase measures (the engine's
#: serving dtype; the CPU rehearsal takes the CPU at f32)
CAL_DEVICE = "cuda"
CAL_DTYPE = torch.bfloat16
#: the R^2 every non-proxy fit must reach (the reference's ``min_r2``)
CAL_MIN_R2 = 0.9
#: the card's peak rate per unit of each primitive's x: GEMM and
#: attention in FLOP (2 per m·k·n; 2 per unit of N_h·B·S^2·(d_k+d_v) for
#: the full square, of which a causal kernel does half), decode in bytes
#: read, the copy proxy in bytes read and written (2 per byte)
CAL_PEAK = {"gemm": (2, PEAK_FLOPS[torch.bfloat16], "FLOP/s"),
            "attn": (2, PEAK_FLOPS[torch.bfloat16], "FLOP/s (full S^2)"),
            "decode": (1, HBM_BYTES_PER_S, "B/s"),
            "comm": (2, HBM_BYTES_PER_S, "B/s")}


def sweep_calls(sweep, retries: int) -> int:
    """Kernel calls of a sweep: warm-up and timed calls per sample (the
    full sweep's 2 + 9), once and again per retry."""
    return len(sweep) * (2 + 9) * (1 + retries)


def phase_calibrate(store_dir: str):
    """``calibrate()`` on the card at bf16 over the card's sweeps (full:
    2 warm-up and 9 timed calls per sample), into a fresh store. Prints
    each primitive's samples, fit, proxy flag, retries and implied rate;
    fails on a non-proxy fit with R^2 under ``CAL_MIN_R2`` or beta <= 0,
    on flash or decode-attention launches other than the sweeps' calls,
    and unless the stored profile loads back bit for bit. Returns the
    fitted profile."""
    device = torch.device(CAL_DEVICE)
    key = ProfileKey.for_host(None, CAL_DTYPE, device)
    kernel_lib.reset_launch_counts()
    res = calibrate(name=key.slug(), fast=False, dtype=CAL_DTYPE,
                    device=device, min_r2=CAL_MIN_R2)
    counts = kernel_lib.launch_counts()
    hw = res.profile
    print(f"[calibrate] {key.device_kind}, {CAL_DTYPE}: {res.wall_s:.2f} s "
          f"wall; profile {hw.name!r}")
    for kind, s in res.samples.items():
        fit = getattr(hw, kind)
        mult, peak, unit = CAL_PEAK[kind]
        rate = mult / fit.beta if fit.beta > 0 else float("nan")
        note = (" (proxy: an on-card copy, one card has no wire; plans "
                "on it see transport as nearly free)" if kind == "comm"
                and s.proxy else " (proxy)" if s.proxy else "")
        print(f"[calibrate] {kind}: alpha {fit.alpha:.6e} s, beta "
              f"{fit.beta:.6e} s/unit, R^2 {res.fit_r2[kind]:.6f}, proxy "
              f"{s.proxy}, retries {res.retries[kind]}; beta implies "
              f"{rate:.4e} {unit} against the card's peak {peak:.4e} "
              f"({rate / peak:.1%}){note}")
        print(f"[calibrate] {kind} samples (x, median ms): " + json.dumps(
            [[x, t * 1e3] for x, t in zip(s.xs, s.ts)]))
        if not s.proxy and res.fit_r2[kind] < CAL_MIN_R2:
            fail(f"calibrate: {kind} fits with R^2 {res.fit_r2[kind]:.4f} "
                 f"< {CAL_MIN_R2}")
        if not s.proxy and fit.beta <= 0:
            fail(f"calibrate: {kind} beta {fit.beta:.3e} <= 0")
    sweeps = sweeps_for(device, fast=False)
    # the CPU rehearsal times the plain versions, which count no launch
    on_card = device.type == "cuda"
    want = {"flash_attention": sweep_calls(
                sweeps.attn, res.retries["attn"]) * on_card,
            "decode_attention": sweep_calls(
                sweeps.decode, res.retries["decode"]) * on_card}
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"calibrate: {name} launched {n} times, the sweeps call it "
                 f"{want.get(name, 0)} times")
    store = ProfileStore(store_dir)
    stored = store.put_calibration(res, key)
    back = store.get(stored.name)
    if (back.profile != hw or back.profile.as_dict() != hw.as_dict()
            or back.fit_r2 != res.fit_r2 or back.key != key
            or back.comm_proxy != res.comm_is_proxy
            or back.samples != {k: v.as_xt()
                                for k, v in res.samples.items()}):
        fail("calibrate: the stored profile does not load back bit for bit")
    print(f"[calibrate] launches {counts}; stored as {stored.name!r} and "
          "loaded back bit for bit; " + json.dumps(dict(
              key=key.as_dict(), profile=hw.as_dict(), fit_r2=res.fit_r2,
              retries=res.retries, wall_s=res.wall_s,
              comm_proxy=res.comm_is_proxy, launches=counts)))
    return hw, counts


# ---------------------------------------------------------------------------
# phase 4: serve the full-width models, one path at a time
# ---------------------------------------------------------------------------

def mixed_requests(cfg, seed: int = 0):
    """16 requests with prompts of 16-600 tokens and 32 new tokens, even
    ones greedy and odd ones at temperature 0.8."""
    rng = np.random.RandomState(seed)
    reqs = []
    for i in range(16):
        n = int(rng.randint(16, 601))
        reqs.append(Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                    size=n)),
                            max_new_tokens=32,
                            temperature=0.0 if i % 2 == 0 else 0.8))
    return reqs


def pressure_requests(vocab: int):
    """16 requests sharing a 256-token system prompt, each with a unique
    tail of 16-344 tokens and 32 new tokens, all greedy."""
    rng = np.random.RandomState(1)
    shared = list(rng.randint(0, vocab, size=256))
    return [Request(prompt=shared + list(rng.randint(
        0, vocab, size=int(rng.randint(16, 345)))), max_new_tokens=32)
        for _ in range(16)]


#: pages of the pressure run's pool (scratch page included): small enough
#: that the run preempts, found with the smoke model on the CPU (paging
#: decisions depend only on token counts and prefix equality)
PRESSURE_BLOCKS = 57


def run_stepwise(eng, check):
    """``eng.run()`` one step at a time: after each step ``check(before,
    after, programs)`` gets the launch counts around it and the DEP
    programs of its model calls. Returns the requests finished."""
    start = len(eng.finished)
    while True:
        before, n = kernel_lib.launch_counts(), len(eng.stats.programs)
        busy = eng.step()
        check(before, kernel_lib.launch_counts(), eng.stats.programs[n:])
        if not busy and not eng.waiting:
            return eng.finished[start:]


def serve(eng, reqs, cfg, path: str, expect, step_check=None, into=None):
    """Drive ``reqs`` through ``eng`` with the launch counts set to 0 just
    before and read just after (and ``step_check``, if given, after every
    step: ``run_stepwise``); check that every request finished with 32
    tokens of the vocabulary and that every kernel launched exactly as
    often as ``expect(eng.stats)`` says (a kernel absent from it must not
    launch). An engine with the decode graph must replay it at every
    decode step and capture no key twice (one capture per graph it
    holds); an eager one must capture nothing. The printed numbers also
    go into the dict ``into``, if given."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_gb = torch.cuda.memory_allocated() / 1e9
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    finished = (eng.run() if step_check is None
                else run_stepwise(eng, step_check))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_lib.launch_counts()
    if len(finished) != len(reqs):
        fail(f"{path}: served {len(finished)}/{len(reqs)} requests")
    for r in reqs:
        if r.state != RequestState.FINISHED or len(r.output) != 32:
            fail(f"{path}: request {r.request_id}: {r.state} with "
                 f"{len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            fail(f"{path}: request {r.request_id}: token out of the "
                 "vocabulary")
    st = eng.stats
    want = expect(st)
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{path}: {name} launched {n} times, expected "
                 f"{want.get(name, 0)}")
    if eng.decode_graph:
        if st.graph_captures != len(eng._graphs.graphs):
            fail(f"{path}: {st.graph_captures} graph captures for "
                 f"{len(eng._graphs.graphs)} keys")
        if st.graph_replays != st.steps:
            fail(f"{path}: {st.graph_replays} graph replays for {st.steps} "
                 "decode steps")
    elif st.graph_captures or st.graph_replays:
        fail(f"{path}: an eager engine captured or replayed a graph")
    tokens = sum(len(r.output) for r in reqs)
    ttft = np.array([r.ttft for r in reqs]) * 1e3
    res = dict(requests=len(finished), tokens=tokens, wall_s=wall,
               tokens_per_s=tokens / wall, ttft_mean_ms=float(ttft.mean()),
               ttft_p90_ms=float(np.percentile(ttft, 90)),
               decode_steps=st.steps,
               decode_step_ms=st.decode_s / st.steps * 1e3,
               prefill_calls=st.prefill_calls,
               prefill_ms_mean=st.prefill_s / st.prefill_calls * 1e3,
               decode_graph=eng.decode_graph,
               graph_captures=st.graph_captures,
               graph_replays=st.graph_replays, graph_s=st.graph_s,
               allocated_at_start_gb=start_gb,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               peak_reserved_gb=torch.cuda.max_memory_reserved() / 1e9,
               launches=counts)
    if into is not None:
        into.update(res)
    print(f"[{path}] {tokens} tokens for {len(finished)} requests in "
          f"{wall:.2f} s -> {res['tokens_per_s']:.1f} tokens/s; TTFT mean "
          f"{res['ttft_mean_ms']:.0f} ms, p90 {res['ttft_p90_ms']:.0f} ms; "
          f"{st.steps} decode steps at {res['decode_step_ms']:.2f} ms; "
          f"{st.prefill_calls} prefill calls at "
          f"{res['prefill_ms_mean']:.1f} ms; peak memory "
          f"{res['peak_mem_gb']:.2f} GB allocated ({start_gb:.2f} at the "
          f"start), {res['peak_reserved_gb']:.2f} GB reserved")
    print(f"[{path}] decode graph "
          + (f"on: {st.graph_captures} captures, {st.graph_replays} replays "
             f"for {st.steps} decode steps, warm-up and captures "
             f"{st.graph_s:.2f} s" if eng.decode_graph else "off (eager)"))
    print(f"[{path}] launches: {counts}")
    print(f"[{path}] " + json.dumps(res))
    return counts


def decode_kernel_of(cfg):
    """The decode-attention kernel a dense-KV serve of ``cfg`` launches:
    none under MLA, which decodes through the plain masked SDPA over the
    K/V it recomputes from the latent cache, and none over a sliding
    window's ring, which decodes through the plain masked SDPA (both as
    the reference does)."""
    if cfg.mla_kv_lora_rank or is_ring(cfg):
        return None
    return "decode_attention"


def moe_expect(cfg, decode_kernel):
    """Launches of a serve on the capacity path: per layer one decode
    attention (``decode_kernel``; None launches none) per decode step and
    one flash attention per prefill call, and in an MoE model one expert
    GEMM per decode step and per prefill call."""
    L = cfg.num_layers

    def expect(st):
        want = {"flash_attention": L * st.prefill_calls}
        if cfg.is_moe:
            want["moe_gemm"] = L * (st.steps + st.prefill_calls)
        if decode_kernel:
            want[decode_kernel] = L * st.steps
        return want
    return expect


#: prompt lengths of the teacher-forced graph-against-eager phases: mixed,
#: and the first (Lp = 59, pages of 32 up to position 63) writes position
#: 64 at its sixth decode step, so a paged run opens a page mid-window
FORCED_LENGTHS = (60, 16, 137, 250, 301, 404, 517, 600)


def teacher_forced(path, graph_eng, eager_eng, cfg, prompts,
                   steps: int = 10, names=("graph", "eager")) -> None:
    """The graph engine against the eager engine (or any two engines,
    ``names``) on the same weights: both admit the same prompts (even
    ones greedy, odd ones at T=0.8) and decode ``steps`` + 1 steps, every
    step after the first fed the same tokens, drawn from a seed rather
    than sampled. The logits of every step must be bitwise equal (every
    row, dead ones included); under paged KV at least one step must
    decode after a table change."""
    engines = (graph_eng, eager_eng)
    for eng in engines:
        for i, p in enumerate(prompts):
            eng.submit(Request(prompt=list(p), max_new_tokens=steps + 4,
                               temperature=0.0 if i % 2 == 0 else 0.8))
    paged = graph_eng.kv_layout == "paged"
    rng = np.random.RandomState(10)
    after_change = 0
    for k in range(steps + 1):
        before = graph_eng.kv._tables.copy() if paged else None
        if k:
            forced = torch.from_numpy(rng.randint(
                0, cfg.vocab_size, size=(graph_eng.num_slots, 1)))
            for eng in engines:
                eng.last_tokens.copy_(forced)
        for eng in engines:
            eng.step()
        got, want = graph_eng.last_logits, eager_eng.last_logits
        if not torch.equal(got, want):
            diff = (got.float() - want.float()).abs()
            rows = sorted({int(r) for r in (diff > 0).nonzero()[:, 0]})
            fail(f"{path}: {names[0]} and {names[1]} logits differ at "
                 f"decode step {k} in {int((diff > 0).sum())} entries of "
                 f"rows {rows}, by up to {float(diff.max()):.3e}")
        if paged and not np.array_equal(before, graph_eng.kv._tables):
            after_change += 1
    if paged and not after_change:
        fail(f"{path}: no teacher-forced step followed a table change")
    live = sorted(graph_eng.kv.length(s) for s in graph_eng.kv.live_slots())
    for eng in engines:
        eng.run()
    print(f"[{path}] {names[0]} vs {names[1]}, teacher-forced: logits "
          f"bitwise equal at all {steps + 1} decode steps (live slots at "
          f"lengths {live} "
          f"after them" + (f"; {after_change} steps after a table change"
                           if paged else "") + ")")


def against_eager(path, graph_eng, eager_eng, cfg, graph_reqs, make_reqs,
                  expect, prompts) -> None:
    """The eager engine serves ``make_reqs()``, the requests the graph
    engine served as ``graph_reqs``: every greedy request must give the
    graph run's tokens (sampled ones match where the graph's generator
    draws as the eager one's). Then ``teacher_forced`` on ``prompts``."""
    reqs = make_reqs()
    serve(eager_eng, reqs, cfg, f"{path} eager", expect)
    pairs = list(zip(graph_reqs, reqs))
    greedy = [(a, b) for a, b in pairs if a.temperature == 0]
    sampled = [(a, b) for a, b in pairs if a.temperature > 0]
    bad = [i for i, (a, b) in enumerate(pairs)
           if a.temperature == 0 and a.output != b.output]
    if bad:
        fail(f"{path}: greedy requests {bad} differ between the graph and "
             "the eager run")
    same = sum(a.output == b.output for a, b in sampled)
    print(f"[{path}] graph vs eager serve: all {len(greedy)} greedy "
          f"requests give the same tokens; {same}/{len(sampled)} sampled "
          "requests too")
    teacher_forced(path, graph_eng, eager_eng, cfg, prompts)


def forced_prompts(vocab: int, shared=()):
    """Prompts of ``shared`` and then ``FORCED_LENGTHS`` random tokens,
    from a seed (a shared prefix of whole pages keeps the page crossing
    of ``FORCED_LENGTHS[0]``)."""
    rng = np.random.RandomState(12)
    return [list(shared) + list(rng.randint(0, vocab, size=n))
            for n in FORCED_LENGTHS]


def check_sync_guard(eng) -> dict:
    """The card's half of ``analysis.capturelint``: one eager decode step
    of ``eng`` (a serve engine without graphs, after its last timing: its
    public ``decode_fn``, what a graph captures) under
    ``torch.cuda.set_sync_debug_mode("error")`` must run without a
    synchronizing call, for both sampling keys; the control, a step
    followed by ``.item()`` on its tokens, must raise."""
    step = eng.decode_fn
    for key in (GraphKey(False), GraphKey(True)):
        step(key)                         # first use allocates outside
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for key in (GraphKey(False), GraphKey(True)):
            step(key)
        try:
            step(GraphKey(False))[0].sum().item()
            control = None
        except RuntimeError as e:
            control = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if control is None:
        fail("sync guard: the control (.item() after a step) did not raise "
             "under set_sync_debug_mode('error')")
    print("[sync guard] an eager decode step (both sampling keys) ran under "
          "set_sync_debug_mode('error') with no synchronizing call; the "
          f"control raised: {control[:120]}")
    return {"eager_step_syncs": 0, "control": control[:120]}


def phase_serve():
    """The paged path with the dense footprint as its pool, then the dense
    path (slice 1) on the same weights, whose tokens the paged run must
    give; then paged KV under pool pressure (preemption). Paged runs
    first so that the order of the phases does not favour it. Each path
    runs with the decode graph and is held against an eager engine on
    the same weights; a paired timing takes turns between the dense graph,
    the dense eager and the paged graph engines. Returns the launch counts
    of each path's graph run."""
    cfg = get_config("qwen2-moe-a2.7b")
    t0 = time.perf_counter()
    # paged, parity pool: the dense footprint (257 pages of 32)
    eng = ServingEngine(cfg, num_slots=8, max_context=1024,
                        kv_layout="paged", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared_experts} shared, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.2f} B params in bf16 drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    paged_reqs = mixed_requests(cfg)
    expect = moe_expect(cfg, "decode_attention_paged")
    counts["paged"] = serve(eng, paged_reqs, cfg, "paged", expect)
    eng.kv.check_invariants()
    pool = (eng.kv.pool.num_blocks, eng.kv.block_size)
    print(f"[paged] paging_stats {json.dumps(eng.paging_stats())}")
    profile_decode(eng, np.random.RandomState(5), cfg, "paged")
    params = eng.params
    eager = ServingEngine(cfg, params=params, num_slots=8, max_context=1024,
                          kv_layout="paged", dtype=torch.bfloat16, seed=0,
                          decode_graph=False)
    against_eager("paged", eng, eager, cfg, paged_reqs,
                  lambda: mixed_requests(cfg), expect,
                  forced_prompts(cfg.vocab_size))
    eager.kv.check_invariants()
    profile_decode(eager, np.random.RandomState(5), cfg, "paged eager")
    paged_eng = eng
    del eager
    torch.cuda.empty_cache()

    eng = ServingEngine(cfg, params=params, num_slots=8, max_context=1024,
                        dtype=torch.bfloat16, seed=0)
    dense_reqs = mixed_requests(cfg)
    expect = moe_expect(cfg, "decode_attention")
    counts["serve"] = serve(eng, dense_reqs, cfg, "serve", expect)
    print(f"[serve] (decode_attention {cfg.num_layers} per decode step)")
    profile_decode(eng, np.random.RandomState(5), cfg, "serve")
    profile_prefill(eng, np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(8, 300)), "serve")
    eager = ServingEngine(cfg, params=params, num_slots=8, max_context=1024,
                          dtype=torch.bfloat16, seed=0, decode_graph=False)
    against_eager("serve", eng, eager, cfg, dense_reqs,
                  lambda: mixed_requests(cfg), expect,
                  forced_prompts(cfg.vocab_size))
    profile_decode(eager, np.random.RandomState(5), cfg, "serve eager")
    greedy = [(a, b) for i, (a, b) in enumerate(zip(dense_reqs, paged_reqs))
              if i % 2 == 0]
    sampled = [(a, b) for i, (a, b) in enumerate(zip(dense_reqs, paged_reqs))
               if i % 2 == 1]
    bad = [i for i, (a, b) in enumerate(greedy) if a.output != b.output]
    if bad:
        fail(f"paged: greedy requests {bad} differ from the dense run")
    same = sum(a.output == b.output for a, b in sampled)
    print(f"[paged] pool {pool[0]} pages of {pool[1]}: all {len(greedy)} "
          f"greedy requests give the dense run's tokens; {same}/"
          f"{len(sampled)} sampled requests match too")
    compare_decode({"graph": eng, "eager": eager, "paged": paged_eng}, cfg)
    check_sync_guard(eager)
    del eng, eager, paged_eng
    torch.cuda.empty_cache()

    # paged, under pressure: a shared system prompt and a pool that must
    # preempt
    def pressure_engine(**kw):
        return ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, kv_layout="paged",
                             kv_block_size=32, kv_num_blocks=PRESSURE_BLOCKS,
                             dtype=torch.bfloat16, seed=0, **kw)

    eng = pressure_engine()
    reqs = pressure_requests(cfg.vocab_size)
    expect = moe_expect(cfg, "decode_attention_paged")
    counts["pressure"] = serve(eng, reqs, cfg, "pressure", expect)
    eng.kv.check_invariants()
    ps = eng.paging_stats()
    print(f"[pressure] paging_stats {json.dumps(ps)}")
    if ps["preemptions"] < 1:
        fail("pressure: the pool never preempted")
    if not ps["prefix_hit_rate"] > 0:
        fail("pressure: no prefix hits on a shared system prompt")
    if ps["blocks_used"] != ps["blocks_reclaimable"]:
        fail(f"pressure: {ps['blocks_used']} pages in use at the end, "
             f"{ps['blocks_reclaimable']} reclaimable (a leak)")
    print(f"[pressure] {ps['preemptions']} preemptions, prefix hit rate "
          f"{ps['prefix_hit_rate']:.3f}, invariants hold, every page "
          "free or reclaimable at the end")
    eager = pressure_engine(decode_graph=False)
    # a new shared prefix: admission counts parked prefix pages both as
    # free and as hits, so prompts on the parked one can over-commit the
    # pool (ROADMAP Queue 3)
    against_eager("pressure", eng, eager, cfg, reqs,
                  lambda: pressure_requests(cfg.vocab_size), expect,
                  forced_prompts(cfg.vocab_size, shared=np.random.RandomState(
                      14).randint(0, cfg.vocab_size, size=256)))
    if eager.paging_stats() != eng.paging_stats():
        fail(f"pressure: eager paging_stats {eager.paging_stats()} differ "
             f"from the graph run's {eng.paging_stats()}")
    print("[pressure] the eager engine's paging counters equal the graph "
          "engine's")
    for e in (eng, eager):
        e.kv.check_invariants()
    del eng, eager, params
    torch.cuda.empty_cache()
    return counts


def compare_decode(engines, cfg, steps: int = 8, rounds: int = 2) -> None:
    """Paired decode-step wall time of engines on the same host: they take
    turns A, B, ..., ..., B, A in each round, each turn 8 slots at
    300-token prompts decoding ``steps`` steps, so a drift of the host's
    speed weighs on all alike."""
    names = list(engines)
    times = {name: [] for name in names}
    for _ in range(rounds):
        for name in names + names[::-1]:
            eng = engines[name]
            rng = np.random.RandomState(7)
            for _ in range(eng.num_slots):
                eng.submit(Request(prompt=list(rng.randint(
                    0, cfg.vocab_size, size=300)), max_new_tokens=steps + 2))
            eng.step()                  # admit + prefill + first decode
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            times[name].append((time.perf_counter() - t0) * 1e3 / steps)
            eng.run()
    med = {name: float(np.median(t)) for name, t in times.items()}
    print(f"[compare {cfg.name}] decode step ms, turns {'/'.join(names)} "
          "alternating: " + json.dumps({"median": med, "turns": times}))
    return med


# ---------------------------------------------------------------------------
# phase 4b: the DEP path (the FinDEP planner and the DEP executor)
# ---------------------------------------------------------------------------

#: the expert group's backend (the CPU rehearsal takes gloo)
DEP_BACKEND = "nccl"


def dep_policy(cfg, profile):
    """The reference's serving policy (``examples/serve_moe.py``): FinDEP
    on the paper's layout of 3 attention + 5 expert devices with an
    8-sample memory cap, solved on ``profile`` (the calibrate phase's
    measured H100 profile; ``PAPER_A6000`` for the comparison)."""
    return FinDEPPolicy(FinDEPPlanner(cfg, DepClusterConfig(8, 3, 5),
                                      profile,
                                      PlannerConfig(mem_cap_samples=8)))


def exp_launches(programs, layers: int, expert_ranks: int = 1) -> int:
    """Expert-GEMM launches of the model calls that walked ``programs``
    (("prefill" or "decode", ExecProgram) pairs): one per MoE layer and
    (stream, chunk), and, under a placement that replicates hot experts,
    one REP launch per MoE layer and stream of a call in sequence mode:
    every call on one expert rank, only prefill on ``expert_ranks`` > 1
    (a decode step is replicated-token mode there, which has no REP)."""
    return layers * sum(p.graph.r1 * p.graph.r2
                        + (p.graph.r1 if p.graph.hot_experts and (
                            phase == "prefill" or expert_ranks == 1) else 0)
                        for phase, p in programs)


def dep_expect(cfg, since=None, expert_ranks: int = 1):
    """Launches of a DEP serve: attention as on the dense path (no decode
    kernel under MLA), the expert GEMM as ``exp_launches`` of each call's
    program. ``since`` (an engine's ``EngineStats``) counts only the calls
    after this point."""
    L = cfg.num_layers
    dec = decode_kernel_of(cfg)
    steps, calls, n = ((since.steps, since.prefill_calls,
                        len(since.programs)) if since is not None
                       else (0, 0, 0))

    def expect(st):
        want = {"flash_attention": L * (st.prefill_calls - calls),
                "moe_gemm": exp_launches(st.programs[n:], L,
                                         expert_ranks)}
        if dec:
            want[dec] = L * (st.steps - steps)
        return want
    return expect


def launches_per_step(eng, path: str, expect):
    """A ``run_stepwise`` check: every step launched each kernel exactly
    as ``expect`` says of that step's own decode steps, prefill calls and
    DEP programs (a kernel absent from it must not launch). It holds the
    engine's stats, not the engine, which a phase frees before its end."""
    st = eng.stats
    seen = [st.steps, st.prefill_calls]

    def check(before, after, programs):
        step = argparse.Namespace(steps=st.steps - seen[0],
                                  prefill_calls=st.prefill_calls - seen[1],
                                  programs=list(programs))
        want = expect(step)
        for name in after:
            n = after[name] - before[name]
            if n != want.get(name, 0):
                fail(f"{path}: step {check.steps} ({step.steps} decode "
                     f"steps, {step.prefill_calls} prefill calls): {name} "
                     f"launched {n} times, expected {want.get(name, 0)}")
        seen[:] = [st.steps, st.prefill_calls]
        check.steps += 1
    check.steps = 0
    return check


def describe(program) -> str:
    g = program.graph
    return (f"r1={g.r1} r2={g.r2} m_e={g.m_e} {g.order} "
            f"{program.interleave}")


def print_plans(eng, path: str) -> None:
    """Every resolved plan with its key and the profile it was solved on;
    the DEP programs the model calls walked; the decode graph's keys."""
    profile = eng.plan_policy.planner.hardware.name
    for key, plan in eng.resolved_plans().items():
        print(f"[{path}] plan {key}: m_a={plan.m_a} r1={plan.r1} "
              f"m_e={plan.m_e:g} r2={plan.r2} order={plan.order} "
              f"(solved on the {profile} profile)")
    runs = {}
    for phase, prog in eng.stats.programs:
        runs[(phase, prog)] = runs.get((phase, prog), 0) + 1
    for (phase, prog), n in runs.items():
        print(f"[{path}] {phase} program {describe(prog)}: {n} model calls")
    if eng._graphs is not None:
        for key in eng._graphs.graphs:
            print(f"[{path}] decode graph key use_topk={key.use_topk} "
                  f"program {describe(key.plan)}: captured once")


def print_plans_beside(eng, cfg, path: str) -> None:
    """Every plan ``eng`` resolved (on its measured profile) beside the
    plan ``PAPER_A6000`` gives the same (bucket, batch) or occupancy."""
    a6000 = PlanCache(dep_policy(cfg, PAPER_A6000))
    rows = []

    def fields(p):
        return dict(m_a=p.m_a, r1=p.r1, m_e=p.m_e, r2=p.r2, order=p.order,
                    makespan_s=p.makespan)

    for key, plan in eng.resolved_plans().items():
        phase, *rest = key
        if phase == "decode":
            other = a6000.get("decode", occupancy=rest[0])
        else:
            other = a6000.get(phase, rest[0], rest[1])
        rows.append(dict(key=repr(key), measured=fields(plan),
                         paper_a6000=fields(other)))
        print(f"[{path}] plan {key}: measured profile m_a={plan.m_a} "
              f"r1={plan.r1} m_e={plan.m_e:g} r2={plan.r2} {plan.order} "
              f"makespan {plan.makespan * 1e3:.4f} ms | PAPER_A6000 "
              f"m_a={other.m_a} r1={other.r1} m_e={other.m_e:g} "
              f"r2={other.r2} {other.order} makespan "
              f"{other.makespan * 1e3:.4f} ms")
    print(f"[{path}] plans beside PAPER_A6000: " + json.dumps(rows))


def print_telemetry(eng, path: str) -> None:
    """The engine's telemetry, as ``examples/serve_moe.py`` prints it:
    measured against predicted seconds and the residual per phase, then
    per plan key (observations after each key's first, its EWMA)."""
    for phase, st in sorted(eng.telemetry.summary().items()):
        res = st["residual"]
        print(f"[{path}] telemetry {phase:>7}: n={st['count']:<4} measured="
              f"{st['measured_s']:.4f}s predicted={st['predicted_s']:.6f}s "
              + (f"residual={res:+.1%}" if res is not None
                 else "residual=n/a"))
    for key, st in eng.telemetry.keys.items():
        res = ((st.measured_s - st.predicted_s) / st.predicted_s
               if st.predicted_s > 0 else None)
        print(f"[{path}] telemetry key {key}: n={st.count} measured="
              f"{st.measured_s:.4f}s predicted={st.predicted_s:.6f}s "
              + (f"residual={res:+.1%} ewma={st.residual_ewma:+.1%}"
                 if res is not None else "residual=n/a"))


def forced_program() -> ExecProgram:
    """The program no plan of the serve resolves to: r1=2 streams x r2=4
    chunks, ASAS, streams interleaved (eight A2E/E2A pairs per layer)."""
    return ExecProgram(lower_exec(4, "ASAS", 1, r1=2), "streams")


class GemmWidths:
    """While entered, records the capacity width C of every expert-GEMM
    call of the model (``widths``) and the (E, C) of every call
    (``shapes``; REP's E is the hot experts'). ``models.moe`` calls the
    wrapper through its module global; a graph capture calls it, a
    replay does not."""

    def __enter__(self):
        self.widths, self.shapes = set(), set()
        self._wrapped = moe_lib.moe_gemm

        def record(x, *args, **kw):
            self.shapes.add((int(x.shape[0]), int(x.shape[1])))
            self.widths.add(int(x.shape[1]))
            return self._wrapped(x, *args, **kw)
        moe_lib.moe_gemm = record
        return self

    def __exit__(self, *exc):
        moe_lib.moe_gemm = self._wrapped


def check_dep_layer(params, cfg, groups, programs, device) -> None:
    """One full-width MoE layer (layer 0 of the served weights, bf16) at
    world size 1, for every distinct program the serve walked and the
    forced r1=2 x r2=4 ASAS program: ``moe_apply_dep`` against
    ``moe_apply_capacity`` at the capacity the program's multiple gives.
    Bitwise equal where r2 = 1 and the shared expert runs as one segment;
    elsewhere within ``GEMM_TOL`` (cuBLAS may pick another algorithm for a
    row range of the shared GEMM). Both sides reach the same expert-GEMM
    kernel, so this holds the walk, not the kernel: ``check_dep_widths``
    holds the kernel against its plain version at the same widths."""
    p = params["layers"][0]["moe"]
    M = cfg.d_model
    shapes = {"decode": (8, 1), "prefill": (2, 512)}
    cases = list(dict.fromkeys(programs)) + [("decode", forced_program())]
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    for phase, prog in cases:
        B, S = shapes[phase]
        x = torch.randn((B, S, M), generator=gen, device=device).to(
            torch.bfloat16)
        cap = moe_lib.expert_capacity(B * S, cfg.moe,
                                      multiple_of=prog.capacity_multiple)
        got, _ = moe_apply_dep(p, x, cfg.moe, groups, plan=prog,
                               with_aux=False, sequence=True,
                               batch_sharded=False)     # one rank
        want, _ = moe_lib.moe_apply_capacity(p, x, cfg.moe, capacity=cap)
        g = prog.graph
        exact = g.r2 == 1 and g.r1 * g.shared_segments == 1
        err = float((got.float() - want.float()).abs().max())
        if exact:
            if not torch.equal(got, want):
                fail(f"dep layer {phase} {describe(prog)}: not bitwise "
                     f"equal to the capacity path (max |d| {err:.3e})")
            verdict = "bitwise equal"
        else:
            ratio = _worst(got.float(), want.float(), GEMM_TOL[torch.bfloat16])
            if not torch.isfinite(got).all() or ratio > 1:
                fail(f"dep layer {phase} {describe(prog)}: {ratio:.2f} of "
                     "GEMM_TOL against the capacity path")
            verdict = (f"within GEMM_TOL (worst {ratio:.3f} of the limit, "
                       f"max |d| {err:.3e})")
        print(f"[dep layer] {phase} x{list(x.shape)} {describe(prog)}, "
              f"capacity {cap}: {verdict}")


def check_dep_widths(weights, shapes, device, path: str = "dep") -> None:
    """The expert-GEMM kernel against its plain version at every shape
    (E, C) the DEP path gave it, bf16 at ``GEMM_TOL``: on the served
    weights of E experts (``weights[E]``: the stacked experts, or the REP
    task's hot experts), and on weights at ``check_moe_gemm``'s scale
    (outputs ~0.6) beside its controls, which must fail the limit in every
    row they change, so that the limit can see a fault at each shape.
    Prints each comparison's worst ratio; any above 1 fails."""
    gen = torch.Generator(device=device)
    gen.manual_seed(4)

    def draw(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=device)
                * scale).to(torch.bfloat16)

    missing = {e for e, _ in shapes} - set(weights)
    if missing:
        fail(f"{path}: no served weights for the expert GEMM at E in "
             f"{sorted(missing)}")
    worst = {}
    for E in sorted({e for e, _ in shapes}):
        ex = weights[E]
        _, M, H = ex["gate"].shape
        scaled = (draw((E, M, H), M ** -0.5), draw((E, M, H), M ** -0.5),
                  draw((E, H, M), H ** -0.5))
        for c in sorted(c for e, c in shapes if e == E):
            x = draw((E, c, M))
            for label, ws in (("served",
                               (ex["gate"], ex["up"], ex["down"])),
                              ("scaled", scaled)):
                name = (f"{path} width E={E} C={c} M={M} H={H} {label} "
                        "weights")
                got, want = moe_gemm(x, *ws), moe_gemm_ref(x, *ws)
                compare(name, got, want, torch.bfloat16,
                        GEMM_TOL[torch.bfloat16])
                worst[f"E={E} C={c} {label}"] = _worst(
                    got.float(), want.float(), GEMM_TOL[torch.bfloat16])
                if label == "scaled":
                    check_moe_gemm_controls(name, got, x, *ws, want)
                del got, want
    print(f"[{path} layer] expert GEMM against its plain version at every "
          f"(E, C) the path gave it {sorted(shapes)}: worst "
          f"{max(worst.values()):.3f} of GEMM_TOL " + json.dumps(worst))


def back_to_back_ms(fn, calls: int = 20, iters: int = 5) -> float:
    """Device-bound time per call of ``fn``: CUDA events around ``calls``
    back-to-back calls (median of ``iters``). The card stays busy when a
    call's kernels outlast its host path, as the expert GEMM's 0.3 ms and
    more do, so this is the kernels' time and the gaps between them."""
    return time_ms(lambda: [fn() for _ in range(calls)],
                   iters=iters) / calls


def time_dep_chunks(p, widths, device) -> dict:
    """Time of one expert-GEMM launch over every expert at each DEP chunk
    width C (weights bf16, as served): CUDA events around one call, and
    around 20 back-to-back calls, which must not read below the bound.
    Not the profiler: late in a run its traces of these calls come back
    without their last kernels, every time (``device_ms`` counts them and
    fails). Returns {C: [events ms, back-to-back ms, bound ms]}."""
    ex = p["experts"]
    E, M, H = ex["gate"].shape
    gen = torch.Generator(device=device)
    gen.manual_seed(4)
    res = {}
    for c in widths:
        x = torch.randn((E, c, M), generator=gen, device=device).to(
            torch.bfloat16)
        b, _ = work_bound(moe_gemm_work, x, ex["gate"], ex["up"], ex["down"])

        def call():
            return moe_gemm(x, ex["gate"], ex["up"], ex["down"])
        res[c] = [time_ms(call), back_to_back_ms(call), b]
        if res[c][1] < b:
            fail(f"dep width C={c}: the expert GEMM read {res[c][1]:.4f} ms "
                 f"a call back to back, below its bound {b:.4f} ms")
    print("[dep layer] expert GEMM ms per launch at the DEP chunk widths "
          "(C: [events one call, events over 20 back-to-back calls, "
          "bound]): " + json.dumps(res))
    return res


def time_dep_alltoall(groups, widths, M, E, device) -> None:
    """Time of one A2E all_to_all_single over the expert group ([E, C, M]
    bf16) at each DEP chunk width C, CUDA events around each call (the
    profiler records no device event for it outside a graph; inside one,
    at world size 1, it is a device-to-device copy)."""
    res = {}
    for c in widths:
        send = torch.zeros((E, c, M), dtype=torch.bfloat16, device=device)
        recv = torch.empty_like(send)
        res[c] = time_ms(lambda: torch.distributed.all_to_all_single(
            recv, send, group=groups.expert))
    print(f"[dep layer] all_to_all ms per call over {groups.expert_size} "
          "rank(s) at the DEP chunk widths (C: ms, events): "
          + json.dumps(res))


def force_decode_program(eng, program):
    """Make every decode step of ``eng`` walk ``program`` in place of the
    one its decode plan lowers to (prefill keeps its plans). The override
    holds the engine weakly: through a cycle a dropped engine, its
    weights included, would stay on the card until the collector ran."""
    exec_program = type(eng)._exec_program
    ref = weakref.ref(eng)

    def forced(plan, streams=None):
        return (program if streams is None
                else exec_program(ref(), plan, streams))
    eng._exec_program = forced
    return eng


def check_forced_graph(engine, params, cfg) -> None:
    """The forced r1=2 x r2=4 program in a real CUDA graph: eight A2E/E2A
    pairs per layer on the comm stream, each ordered by its (stream,
    chunk) events, forked from and joined into the capture stream. A
    graph engine whose every decode step walks it, against an eager one
    with the same override, teacher-forced: the logits must be bitwise
    equal at every step; the graph engine must hold one graph, of that
    program, captured once (after the engine's one warm-up on the
    unchunked program) with 24 x 8 expert-GEMM launches and replayed at
    every step; both engines' launches must equal 24 x sum(r1*r2) over
    their calls' programs."""
    prog = forced_program()
    graph = force_decode_program(engine(params), prog)
    eager = force_decode_program(engine(params, decode_graph=False), prog)
    kernel_lib.reset_launch_counts()
    teacher_forced("dep forced", graph, eager, cfg,
                   forced_prompts(cfg.vocab_size))
    L = cfg.num_layers
    n = kernel_lib.launch_counts()["moe_gemm"]
    want = (exp_launches(graph.stats.programs, L)
            + exp_launches(eager.stats.programs, L))
    if n != want:
        fail(f"dep forced: the expert GEMM launched {n} times, the programs "
             f"ask for {want}")
    decode = {p for ph, p in graph.stats.programs if ph == "decode"}
    keys = graph._graphs.graphs
    st = graph.stats
    if decode != {prog} or {k.plan for k in keys} != {prog}:
        fail(f"dep forced: decode walked {len(decode)} programs, graphs of "
             f"{len(keys)}; want the forced program alone")
    launches = [c.launches["moe_gemm"] for c in keys.values()]
    if (st.graph_captures != len(keys) or st.graph_replays != st.steps
            or launches != [L * 8] * len(keys)):
        fail(f"dep forced: {st.graph_captures} captures of {len(keys)} "
             f"keys, {st.graph_replays} replays for {st.steps} steps, "
             f"{launches} expert-GEMM launches per replay (want {L * 8})")
    print(f"[dep forced] {describe(prog)} captured once per key "
          f"({len(keys)}), {L * 8} expert-GEMM launches per replay, "
          f"{st.graph_replays} replays for {st.steps} steps; launches "
          f"{n} = {L} x sum(r1*r2) of both engines' calls")


#: the drift phase's residual threshold (|EWMA residual|) and samples per
#: key before it may trip, and how often its engine polls the profile
#: store (max age 0: every poll re-calibrates). A finished re-calibration
#: restarts every key's residual history and a drift episode waits for
#: the worker to be idle, so drift can trip only between calibrations: a
#: poll every 0.5 s kept the worker busy through the serve on an H100 (a
#: sweep took 1.2 s under load) and no drift event tripped.
DRIFT_THRESHOLD = 0.5
DRIFT_MIN_SAMPLES = 1
DRIFT_POLL_S = 1.5


def check_drift(engine, params, cfg, store_dir: str, clean) -> None:
    """A dep engine with ``drift_threshold`` and ``recalibrate_max_age_s=0``
    over a fresh store under ``store_dir`` serves the dep phase's requests
    on its weights, one step at a time: the re-calibrations run on the
    refresh worker, on the engine's calibration stream, while it serves. Every request
    must finish with 32 tokens, the graph replay once per decode step and
    capture no key twice, the expert GEMM launch 24 x sum(r1·r2) of the
    calls' programs (the calibration does not launch it; the attention
    kernels' counts include its sweeps), and at least one re-calibration
    and one re-solve must land before the serve ends. Prints the drift
    events, re-solves, re-calibrations and the programs first captured
    mid-serve, with the step at which each showed, and each
    re-calibration's betas against ``clean`` (the calibrate phase's
    profile, taken on an idle card)."""
    eng = engine(params, drift_threshold=DRIFT_THRESHOLD,
                 drift_min_samples=DRIFT_MIN_SAMPLES,
                 profile_store=os.path.join(store_dir, "drift"),
                 recalibrate_max_age_s=0.0)
    eng.recalibrator.poll_interval_s = DRIFT_POLL_S
    recals, calibrate_fn, stats = [], eng.recalibrator.calibrate_fn, eng.stats

    def recorded():
        """The engine's calibration job, noting the decode steps it
        overlapped (``stats``, not the engine: no cycle through it)."""
        start, s0 = stats.steps, time.perf_counter() - t0
        res = calibrate_fn()
        recals.append(dict(
            steps=[start, stats.steps],
            s=[s0, time.perf_counter() - t0], wall_s=res.wall_s,
            beta_vs_idle={k: getattr(res.profile, k).beta
                          / getattr(clean, k).beta for k in res.fit_r2},
            fit_r2=res.fit_r2))
        return res
    eng.recalibrator.calibrate_fn = recorded
    # the graphs' warm-up before the first poll, so that the first
    # re-calibration overlaps the serve and does not hold up the warm-up
    eng._ensure_caches()
    reqs = mixed_requests(cfg)
    kernel_lib.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    step, seen, events = 0, set(), []
    state = (0, 0, 0)
    while True:
        busy = eng.step()
        step += 1
        now = (eng.recalibrator.recalibrations, eng.plan_cache.stats.refreshes,
               eng.drift.stats.drift_events)
        if now != state:
            events.append(dict(step=step, s=time.perf_counter() - t0,
                               recalibrations=now[0], re_solves=now[1],
                               drift_events=now[2]))
            state = now
        for key in set(eng._graphs.graphs) - seen:
            seen.add(key)
            print(f"[drift] step {step}: captured use_topk={key.use_topk} "
                  f"program {describe(key.plan)}"
                  + (" (first met mid-serve)" if eng.stats.steps > 1 else ""))
        if not busy and not eng.waiting:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_recal, resolves = state[0], state[1]
    counts = kernel_lib.launch_counts()
    st = eng.stats
    eng.close()                     # waits for the worker's last job
    for r in reqs:
        if r.state != RequestState.FINISHED or len(r.output) != 32:
            fail(f"drift: request {r.request_id}: {r.state} with "
                 f"{len(r.output)} tokens")
    if (st.graph_replays != st.steps
            or st.graph_captures != len(eng._graphs.graphs)):
        fail(f"drift: {st.graph_replays} replays for {st.steps} steps, "
             f"{st.graph_captures} captures of {len(eng._graphs.graphs)} "
             "keys")
    L = cfg.num_layers
    if counts["moe_gemm"] != exp_launches(st.programs, L):
        fail(f"drift: the expert GEMM launched {counts['moe_gemm']} times, "
             f"the programs ask for {exp_launches(st.programs, L)}")
    if (counts["decode_attention"] < L * st.steps
            or counts["flash_attention"] < L * st.prefill_calls):
        fail(f"drift: attention launches {counts} below the serve's")
    if n_recal < 1 or resolves < 1:
        fail(f"drift: {n_recal} re-calibrations and {resolves} re-solves "
             "landed while serving; want at least one each")
    ds = eng.drift.stats
    print(f"[drift] served {len(reqs)} requests in {wall:.2f} s: "
          f"{st.steps} decode steps, {st.prefill_calls} prefill calls; "
          f"{st.graph_captures} captures ({len(seen)} keys), "
          f"{st.graph_replays} replays; while serving "
          f"{n_recal} re-calibrations and {resolves} re-solves; after the "
          f"worker drained {eng.recalibrator.recalibrations} and "
          f"{eng.plan_cache.stats.refreshes}; {ds.drift_events} drift "
          f"events over {ds.observations} observations (per key "
          f"{ds.per_key_events}, last at residual "
          f"{ds.last_drift_residual}, last scales {ds.last_scales})")
    print("[drift] events by step: " + json.dumps(events))
    print(f"[drift] launches {counts}")
    print("[drift] re-calibrations (decode steps and seconds they spanned, "
          "beta over the idle card's): " + json.dumps(recals))
    print_telemetry(eng, "drift")


def phase_serve_dep(profile, store_dir: str):
    """The DEP path: full qwen2-moe-a2.7b on the serve path's weights
    (seed 0) and its 16 requests, with the FinDEP policy and an NCCL
    expert group of one rank, so every MoE layer walks its plan's program
    (A2E/E2A all_to_all on the comm stream, the expert GEMM per (stream,
    chunk)). Checks: the expert GEMM's launches every step; greedy tokens
    and 11 teacher-forced steps' logits of the graph engine against an
    eager one; interleave "streams" against "off" bitwise; the forced
    r1=2 x r2=4 program captured in a graph against its eager run; one
    layer against the capacity path; the expert GEMM against its plain
    version at every width the path gave it. Profiles a decode step and
    a prefill admission and times the DEP graph engine against the
    capacity graph engine. Returns the launch counts of the serve."""
    cfg = get_config("qwen2-moe-a2.7b")
    # NCCL's bootstrap stays on the loopback interface
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    groups = DepGroups.single(DEP_BACKEND)

    def engine(params=None, **kw):
        return ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, dtype=torch.bfloat16, seed=0,
                             plan_policy=dep_policy(cfg, profile),
                             ep_group=groups, **kw)

    eng = engine()
    torch.cuda.synchronize()
    print(f"[dep] expert group: {DEP_BACKEND}, {groups.world_size} rank; "
          f"engine with weights drawn in {time.perf_counter() - t0:.1f} s")
    params = eng.params
    reqs = mixed_requests(cfg)
    expect = dep_expect(cfg)
    step_check = launches_per_step(eng, "dep", expect)
    with GemmWidths() as rec:
        counts = serve(eng, reqs, cfg, "dep", expect, step_check=step_check)
        print(f"[dep] every kernel launched as its step asked at all "
              f"{step_check.steps} steps: the expert GEMM {cfg.num_layers} "
              "x sum(r1*r2) of the step's programs")
        print_plans(eng, "dep")
        print_plans_beside(eng, cfg, "dep")
        print_telemetry(eng, "dep")
        profile_decode(eng, np.random.RandomState(5), cfg, "dep")
        prompts = np.random.RandomState(8).randint(0, cfg.vocab_size,
                                                   size=(8, 300))
        chunk, _ = prefill_split(dep_policy(cfg, profile).resolve(
            "prefill", 512, 8), 8)
        profile_prefill(eng, prompts, "dep", calls=-(-8 // chunk))
        eager = engine(params, decode_graph=False)
        against_eager("dep", eng, eager, cfg, reqs,
                      lambda: mixed_requests(cfg), expect,
                      forced_prompts(cfg.vocab_size))
        del eager
        off = engine(params, interleave="off")
        teacher_forced("dep", eng, off, cfg, forced_prompts(cfg.vocab_size),
                       names=("streams", "off"))
        del off
        check_forced_graph(engine, params, cfg)
        torch.cuda.empty_cache()
        check_dep_layer(params, cfg, groups, eng.stats.programs, eng.device)
    widths = sorted(rec.widths)
    p = params["layers"][0]["moe"]
    E = p["experts"]["gate"].shape[0]
    check_dep_widths({E: p["experts"]}, {(E, c) for c in widths}, eng.device)
    time_dep_chunks(p, widths, eng.device)
    time_dep_alltoall(groups, widths, cfg.d_model,
                      p["experts"]["gate"].shape[0], eng.device)
    capacity = ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, dtype=torch.bfloat16, seed=0)
    compare_decode({"dep graph": eng, "capacity graph": capacity}, cfg)
    del capacity
    check_drift(engine, params, cfg, store_dir, profile)
    del eng, params, p
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 0.5:
        fail(f"dep: {left:.2f} GB still allocated after the phase: an "
             "engine outlived it")
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 4c: expert-load telemetry and placement
# ---------------------------------------------------------------------------

#: the placement engine's re-placement threshold (the reference example's);
#: at one rank the worst rank's load is at most its share, so it never
#: trips and ``rebalance_now()`` re-places
REBALANCE_THRESHOLD = 1.25
#: hot experts the placement engine replicates (the REP task's E)
HOT_K = 2


def tpot_ms(reqs) -> float:
    return float(np.mean([r.tpot for r in reqs if r.tpot is not None])) * 1e3


def copy_tracker(src, dst) -> None:
    """Give ``dst``'s load tracker the state of ``src``'s, so that ``dst``
    resolves the same skew, plans and capacity scale from here on."""
    dst.load_tracker._ewma = src.load_tracker._ewma.copy()
    dst.load_tracker.observations = src.load_tracker.observations


def print_placement(eng, path: str) -> None:
    """``expert_load()``, and each resolved plan with the skew it was
    solved under and the capacity scale that skew gives."""
    print(f"[{path}] expert_load " + json.dumps(eng.expert_load()))
    for key, plan in eng.resolved_plans().items():
        skew = key[-1] if isinstance(key[-1], SkewSummary) else None
        print(f"[{path}] plan {key[:-1] if skew else key}: r1={plan.r1} "
              f"r2={plan.r2} m_e={plan.m_e:g} {plan.order}; skew {skew}, "
              f"capacity scale {eng._capacity_scale(skew)}")
    if eng._graphs is not None:
        for key in eng._graphs.graphs:
            print(f"[{path}] decode graph key use_topk={key.use_topk} "
                  f"program {describe(key.plan)} hot={key.plan.graph.hot_experts} "
                  f"epoch={key.plan.graph.placement_epoch} cap_scale="
                  f"{key.cap_scale} collect_stats={key.collect_stats} "
                  f"placement={'set' if key.placement is not None else None}")


def host_timer(fn, times):
    """``fn`` with the host milliseconds of each call appended to
    ``times``."""
    def timed(*args):
        t0 = time.perf_counter()
        out = fn(*args)
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return timed


def check_tracking(untracked, tracked, cfg) -> None:
    """(a) The tracked engine (capacity widening off, so tracking is its
    only difference) against the untracked one, both having served the
    same requests: the same greedy tokens; the untracked engine's graph
    keys those of its programs with no placement, scale 1 and no stats,
    the tracked engine's the same with stats; a profiled decode step of
    the untracked engine makes 1 cudaGraphLaunch and 2 cudaLaunchKernel,
    one of the tracked engine no more launches and no more syncs.
    Prints both engines' host calls per step, paired decode-step medians,
    the plan solves in the paired turns, and the tracked engine's host
    time per step in the tracker's EWMA, the stats readbacks and the
    skew summary."""
    ku, kt = set(untracked._graphs.graphs), set(tracked._graphs.graphs)
    if not ku or any(k != GraphKey(k.use_topk, k.plan) for k in ku):
        fail(f"placement: untracked graph keys {ku} carry placement "
             "fields")
    if {k._replace(collect_stats=False) for k in kt} != ku \
            or not all(k.collect_stats for k in kt):
        fail(f"placement: tracked keys {kt} are not the untracked keys "
             f"{ku} with collect_stats")
    rows = {name: profile_decode(e, np.random.RandomState(5), cfg,
                                 f"placement {name}")
            for name, e in (("untracked", untracked), ("tracked", tracked))}
    calls = (rows["untracked"]["cudaGraphLaunch"],
             rows["untracked"]["cudaLaunchKernel"])
    if calls != (1, 2):
        fail(f"placement: the untracked engine's decode step makes "
             f"{calls} (cudaGraphLaunch, cudaLaunchKernel), want (1, 2)")
    extra = {k: rows["tracked"][k] - rows["untracked"][k]
             for k in ("cudaGraphLaunch", "cudaLaunchKernel",
                       "cudaMemcpyAsync", "cudaStreamSynchronize")}
    if extra["cudaStreamSynchronize"] or extra["cudaLaunchKernel"] \
            or extra["cudaGraphLaunch"]:
        fail(f"placement: the tracked decode step makes {json.dumps(extra)} "
             "host calls beyond the untracked one's: its statistics must "
             "leave the graph with no launch or sync of their own")
    before = {name: (e.plan_cache.stats.misses,
                     e.plan_cache.stats.solve_time_total, e.stats.steps)
              for name, e in (("untracked", untracked), ("tracked", tracked))}
    host_ms = {"tracker_ewma": [], "observe_load": [], "skew": []}
    for obj, attr, key in ((tracked.load_tracker, "observe", "tracker_ewma"),
                           (tracked, "_observe_load", "observe_load"),
                           (tracked, "_current_skew", "skew")):
        setattr(obj, attr, host_timer(getattr(obj, attr), host_ms[key]))
    med = compare_decode({"untracked": untracked, "tracked": tracked}, cfg)
    # the instance wrappers hold bound methods: drop them (no cycle)
    del (tracked.load_tracker.observe, tracked._observe_load,
         tracked._current_skew)
    steps = tracked.stats.steps - before["tracked"][2]
    split = {k: sum(v) / steps for k, v in host_ms.items()}
    split["readbacks"] = split["observe_load"] - split["tracker_ewma"]
    print("[placement] tracked engine's host ms per decode step in the "
          "paired turns (observations include its prefill calls'; "
          "readbacks = observe_load - tracker_ewma): " + json.dumps(split))
    solves = {}
    for name, e in (("untracked", untracked), ("tracked", tracked)):
        misses, solve_s, steps = before[name]
        solves[name] = dict(
            plan_misses=e.plan_cache.stats.misses - misses,
            solve_ms=(e.plan_cache.stats.solve_time_total - solve_s) * 1e3,
            engine_steps=e.stats.steps - steps)
    print(f"[placement] tracked engine: {len(kt)} graph keys, the untracked "
          f"ones with collect_stats; host calls per decode step beyond the "
          f"untracked engine's {json.dumps(extra)}; paired decode-step "
          f"median tracked / untracked {med['tracked']:.3f} / "
          f"{med['untracked']:.3f} ms = "
          f"{med['tracked'] / med['untracked']:.4f}; plan solves during the "
          "paired turns (a new skew fingerprint is a new plan key) "
          + json.dumps(solves))


def check_placed_layer(eng, params, cfg, groups) -> None:
    """Layer 0 of the served weights under the placed engine's placement
    (the REP task over its hot experts) and its largest capacity scale,
    for every program the engine walked after the re-placement, against
    ``moe_apply_capacity`` at the same capacity: within ``GEMM_TOL``. Both
    sides reach the same expert-GEMM kernel, so this holds the REP wiring;
    ``check_dep_widths`` holds the kernel at every (E, C) the serve gave
    it."""
    p = params["layers"][0]["moe"]
    lp = eng._device_placement.layer(0)
    scale = max(k.cap_scale for k in eng._graphs.graphs)
    shapes = {"decode": (8, 1), "prefill": (2, 512)}
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(11)
    cases = dict.fromkeys((ph, prog) for ph, prog in eng.stats.programs
                          if prog.graph.hot_experts)
    for phase, prog in cases:
        B, S = shapes[phase]
        x = torch.randn((B, S, cfg.d_model), generator=gen,
                        device=eng.device).to(torch.bfloat16)
        cap = moe_lib.expert_capacity(B * S, cfg.moe,
                                      multiple_of=prog.capacity_multiple,
                                      scale=scale)
        got = moe_apply_dep(p, x, cfg.moe, groups, plan=prog, with_aux=False,
                            capacity_scale=scale, sequence=True,
                            batch_sharded=False, **lp._asdict())[0]
        want = moe_lib.moe_apply_capacity(p, x, cfg.moe, capacity=cap)[0]
        ratio = _worst(got.float(), want.float(), GEMM_TOL[torch.bfloat16])
        if not torch.isfinite(got).all() or ratio > 1:
            fail(f"placement layer {phase} {describe(prog)}: {ratio:.3f} of "
                 "GEMM_TOL from the capacity path")
        print(f"[placement layer] {phase} x{list(x.shape)} {describe(prog)} "
              f"hot={prog.graph.hot_experts}, capacity {cap} (scale "
              f"{scale}): within GEMM_TOL of the capacity path (worst "
              f"{ratio:.3f}, {'bitwise' if torch.equal(got, want) else 'not bitwise'})")


def time_rep_gemm(eng, shapes) -> None:
    """The REP task's expert-GEMM time per launch at each width it ran
    (E = the hot experts), on the placement's hot weights of layer 0:
    CUDA events around one call and around 20 back-to-back calls, beside
    the bound."""
    hw = eng._device_placement.hot_weights[0]
    E, M, H = hw["gate"].shape
    gen = torch.Generator(device=eng.device)
    gen.manual_seed(12)
    res = {}
    for e, c in sorted(shapes):
        if e != E:
            continue
        x = torch.randn((E, c, M), generator=gen, device=eng.device).to(
            torch.bfloat16)
        b, _ = work_bound(moe_gemm_work, x, hw["gate"], hw["up"], hw["down"])

        def call():
            return moe_gemm(x, hw["gate"], hw["up"], hw["down"])
        res[c] = [time_ms(call), back_to_back_ms(call), b]
    print(f"[placement] REP expert GEMM ms per launch at E={E} (C: [events "
          "one call, events over 20 back-to-back calls, bound]): "
          + json.dumps(res))


def expert_fingerprints(params):
    """Per MoE layer and expert tensor, one exact int64 sum of each
    expert's raw 16-bit words: equal rows give equal sums."""
    return {(i, k): t.view(torch.int16).sum(dim=(1, 2), dtype=torch.int64)
            for i, layer in enumerate(params["layers"]) if "moe" in layer
            for k, t in layer["moe"]["experts"].items()}


def check_permutation(eng, cfg) -> None:
    """(c) On an engine holding live slots and captured graphs: install a
    non-identity two-rank placement with ``_apply_placement`` (as the
    reference's own test does without a mesh), then the uniform one,
    which undoes it. After each, every expert tensor is at its address
    and holds the placement's rows (exactly in the first and last MoE
    layer, by per-expert fingerprints in all), and the hot weights are
    the replicated experts' rows. Then each graph captured before the
    permutation is replayed and held bitwise against the eager step on
    the same state (caches, tokens and generator put back between)."""
    E = cfg.moe.num_experts
    layers = eng.params["layers"]
    moe = [i for i, layer in enumerate(layers) if "moe" in layer]
    keys = list(eng._graphs.graphs)
    ptrs = {(i, k): t.data_ptr() for i in moe
            for k, t in layers[i]["moe"]["experts"].items()}
    exact = {i: {k: t.clone() for k, t in layers[i]["moe"]["experts"].items()}
             for i in (moe[0], moe[-1])}
    fps = expert_fingerprints(eng.params)
    loads = np.random.RandomState(6).permutation(E) + 1.0
    pl = rebalance(loads, 2, replicate_hot_k=HOT_K, epoch=1)
    if pl.perm == tuple(range(E)):
        fail("placement: the two-rank placement is the identity")
    for placement in (pl, Placement.uniform(E, 2, epoch=2)):
        eng._apply_placement(placement)
        inv = torch.as_tensor(np.argsort(placement.perm), device=eng.device)
        for (i, k), ptr in ptrs.items():
            t = layers[i]["moe"]["experts"][k]
            if t.data_ptr() != ptr:
                fail(f"placement: layer {i} {k} moved")
            if i in exact and not torch.equal(t, exact[i][k][inv]):
                fail(f"placement: layer {i} {k} does not hold the rows of "
                     f"perm {placement.perm}")
        after = expert_fingerprints(eng.params)
        for key, fp in fps.items():
            if not torch.equal(after[key], fp[inv]):
                fail(f"placement: layer {key[0]} {key[1]} fingerprints do "
                     "not follow the permutation")
        dp = eng._device_placement
        for i in moe:
            for k, t in layers[i]["moe"]["experts"].items():
                hot = dp.hot_weights[i]
                if placement.hot_experts and not torch.equal(
                        hot[k], t[[placement.perm[e]
                                   for e in placement.replicated]]):
                    fail(f"placement: layer {i} {k} hot weights are not the "
                         "replicated experts' rows")
        print(f"[placement] {'applied' if placement is pl else 'undone'}: "
              f"perm {list(placement.perm)}, hot {placement.replicated}, "
              f"epoch {placement.epoch}: {len(ptrs)} expert tensors in "
              "place, rows as the placement says")
    for key in keys:
        snap = [{n: t.clone() for n, t in c.items()} for c in eng.kv.caches]
        tokens, rng = eng.last_tokens.clone(), eng.generator.get_state()

        def restore():
            for c, saved in zip(eng.kv.caches, snap):
                for n, t in c.items():
                    t.copy_(saved[n])
            eng.last_tokens.copy_(tokens)
            eng.generator.set_state(rng)
        graph_logits = eng._graphs(key)[1].clone()
        restore()
        eager_logits = eng._step(key)[1]
        restore()
        if not torch.equal(graph_logits, eager_logits):
            fail(f"placement: the graph of {describe(key.plan)} "
                 f"use_topk={key.use_topk} captured before the permutation "
                 "is not bitwise the eager step after it")
        del snap
    print(f"[placement] {len(keys)} graph(s) captured before the "
          "permutation replay bitwise equal to the eager step after it and "
          "its inverse")


def phase_placement(profile):
    """Expert-load telemetry and placement on full qwen2-moe-a2.7b (bf16,
    seed 0), the dep phase's requests, the calibrate phase's profile and
    an NCCL expert group of one rank. (a) ``check_tracking``: a tracked
    engine against an untracked one. (b) An engine with ``HOT_K`` hot
    experts and a re-placement threshold serves half the requests, re-places
    (``rebalance_now``) and serves the rest: epoch 1, ``HOT_K`` hot
    experts, every skew-keyed plan at the new epoch, the expert GEMM
    ``exp_launches`` (REP included) at every step, the steps after the
    re-placement teacher-forced bitwise against an eager twin given the
    same tracker state and placement, and the placed layer against the
    capacity path (``check_placed_layer``), and the expert GEMM against its
    plain version at every (E, C) of (b)'s serve, REP's included
    (``check_dep_widths``). (c) ``check_permutation``.
    Prints ``expert_load()``, each plan's skew and capacity scale, the REP
    GEMM's time, tokens/s and TPOT of (a) and (b), a decode profile of
    the placed engine and paired decode-step medians of the placed,
    tracked and untracked engines. Returns the launch counts of (b)'s
    serve after the re-placement."""
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-moe-a2.7b")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    groups = DepGroups.single(DEP_BACKEND)

    def engine(params=None, **kw):
        return ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, dtype=torch.bfloat16, seed=0,
                             plan_policy=dep_policy(cfg, profile),
                             ep_group=groups, **kw)

    untracked = engine()
    params = untracked.params
    tracked = engine(params, track_expert_load=True, max_capacity_scale=1.0)
    served = {}
    routed = []             # (assignments, dropped) of each tracked call
    observe = tracked._observe_load

    def count_routed(host):
        routed.append((float(host[:-1].sum()), int(host[-1])))
        observe(host)
    tracked._observe_load = count_routed
    for name, eng in (("untracked", untracked), ("tracked", tracked)):
        reqs = mixed_requests(cfg)
        serve(eng, reqs, cfg, f"placement {name}", dep_expect(cfg),
              step_check=launches_per_step(eng, f"placement {name}",
                                           dep_expect(cfg)))
        served[name] = reqs
        print(f"[placement {name}] TPOT mean {tpot_ms(reqs):.2f} ms")
    del tracked._observe_load, observe      # no cycle through the engine
    pairs = list(zip(served["untracked"], served["tracked"]))
    bad = [i for i, (a, b) in enumerate(pairs)
           if a.temperature == 0 and a.output != b.output]
    if bad:
        fail(f"placement: greedy requests {bad} differ between the tracked "
             "and the untracked engine")
    same = sum(a.output == b.output for a, b in pairs if a.temperature > 0)
    # a decode step routes every slot's token, a prefill call its bucket
    step = tracked.num_slots * cfg.moe.top_k * cfg.num_layers
    share = {phase: [sum(d for r, d in routed if (r == step) == dec),
                     sum(r for r, d in routed if (r == step) == dec)]
             for phase, dec in (("decode", True), ("prefill", False))}
    print(f"[placement] tracked vs untracked: all greedy requests give the "
          f"same tokens; {same}/{len(pairs) // 2} sampled ones too; "
          f"dropped assignments {tracked.stats.dropped_tokens}; "
          "[dropped, routed] over the layers by phase " + json.dumps(share))
    print_placement(tracked, "placement tracked")
    check_tracking(untracked, tracked, cfg)

    eng = engine(params, replicate_hot_k=HOT_K,
                 rebalance_threshold=REBALANCE_THRESHOLD)
    reqs = mixed_requests(cfg)
    with GemmWidths() as rec:
        serve(eng, reqs[:8], cfg, "placement before",
              dep_expect(cfg, eng.stats),
              step_check=launches_per_step(eng, "placement before",
                                           dep_expect(cfg)))
        t0 = time.perf_counter()
        pl = eng.rebalance_now()
        print(f"[placement] rebalance_now: {pl} in "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        if pl.epoch != 1 or pl.hot_experts != HOT_K:
            fail(f"placement: epoch {pl.epoch} with {pl.hot_experts} hot "
                 f"experts after rebalance_now, want 1 and {HOT_K}")
        counts = serve(eng, reqs[8:], cfg, "placement after",
                       dep_expect(cfg, eng.stats),
                       step_check=launches_per_step(eng, "placement after",
                                                    dep_expect(cfg)))
    print(f"[placement] TPOT mean before {tpot_ms(reqs[:8]):.2f} ms, after "
          f"{tpot_ms(reqs[8:]):.2f} ms")
    stale = [k for k in eng.resolved_plans()
             if isinstance(k[-1], SkewSummary) and k[-1].epoch != pl.epoch]
    if stale:
        fail(f"placement: plan keys of an older epoch after the "
             f"re-placement: {stale}")
    rep = [p for _, p in eng.stats.programs if p.graph.hot_experts]
    if not rep or any(p.graph.hot_experts != HOT_K for p in rep):
        fail("placement: no program after the re-placement runs REP")
    print_placement(eng, "placement")
    if pl.perm != tuple(range(cfg.moe.num_experts)):
        fail("placement: a one-rank placement moved experts")
    eager = engine(params, replicate_hot_k=HOT_K,
                   rebalance_threshold=REBALANCE_THRESHOLD,
                   decode_graph=False)
    eager._apply_placement(pl)
    copy_tracker(eng, eager)
    teacher_forced("placement", eng, eager, cfg,
                   forced_prompts(cfg.vocab_size))
    del eager
    profile_decode(eng, np.random.RandomState(5), cfg, "placement placed")
    med = compare_decode({"untracked": untracked, "tracked": tracked,
                          "placed": eng}, cfg)
    print(f"[placement] paired decode-step medians placed (REP over "
          f"{HOT_K} experts, capacity scale up to 4) / tracked / untracked "
          f"{med['placed']:.3f} / {med['tracked']:.3f} / "
          f"{med['untracked']:.3f} ms")
    del tracked
    check_placed_layer(eng, params, cfg, groups)
    experts = params["layers"][0]["moe"]["experts"]
    check_dep_widths({experts["gate"].shape[0]: experts,
                      HOT_K: eng._device_placement.hot_weights[0]},
                     rec.shapes, eng.device, "placement")
    time_rep_gemm(eng, rec.shapes)
    del eng, experts
    torch.cuda.empty_cache()

    eng = untracked
    rng = np.random.RandomState(5)
    for _ in range(eng.num_slots):
        eng.submit(Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                   size=300)),
                           max_new_tokens=4))
    eng.step()
    check_permutation(eng, cfg)
    del eng, untracked, params
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 0.5:
        fail(f"placement: {left:.2f} GB still allocated after the phase: an "
             "engine outlived it")
    torch.cuda.empty_cache()
    print(f"[placement] phase passed in {time.perf_counter() - t_phase:.1f} s")
    return counts


# ---------------------------------------------------------------------------
# phase 4c: observability (the serve entry point, the device trace)
# ---------------------------------------------------------------------------

#: where the obs phase serves (the CPU rehearsal passes "cpu")
OBS_DEVICE = "cuda"


def check_obs_outputs(served, args) -> None:
    """The entry point's outputs read back: the trace file passes
    ``validate_chrome_trace`` and holds every span the tracer recorded;
    the JSONL parses and its TTFT histogram counts every finished
    request, as the Prometheus text parsed back does."""
    eng = served.engine
    n = len(served.finished)
    if n != len(served.requests) or any(
            r.state != RequestState.FINISHED for r in served.requests):
        fail(f"obs: served {n}/{len(served.requests)} requests")
    with open(args.trace_out) as f:
        obj = json.load(f)
    stats = validate_chrome_trace(obj)
    if stats["complete"] != len(eng.tracer):
        fail(f"obs: the trace file holds {stats['complete']} spans, the "
             f"tracer {len(eng.tracer)}")
    with open(args.metrics_out) as f:
        lines = [json.loads(line) for line in f]
    snap = lines[-1]["metrics"]
    samples = parse_prometheus(eng.metrics.render_prometheus())
    prom = {"repro_engine_ttft_seconds_count": [
                v for name, _, v in samples
                if name == "repro_engine_ttft_seconds_count"],
            'repro_engine_requests_total{state="finished"}': [
                v for name, labels, v in samples
                if name == "repro_engine_requests_total"
                and labels == {"state": "finished"}]}
    for name, values in prom.items():
        if snap.get(name) != n or values != [n]:
            fail(f"obs: {name} is {snap.get(name)} in the JSONL and "
                 f"{values} in the Prometheus text; {n} requests finished")
    cats = {}
    for sp in eng.tracer.spans:
        cats[sp.cat] = cats.get(sp.cat, 0) + 1
    print(f"[obs] trace {stats} valid, spans by category {cats}; "
          f"{len(lines)} JSONL line(s), {len(samples)} Prometheus samples "
          "parsed back")


def check_obs_twin(served, args, cfg) -> None:
    """The untraced twin (``tracer=None, metrics=False``) on the same
    weights serves the same requests: the same greedy tokens, the same
    graph keys and captures; both capture no key twice and replay once
    per decode step; and a profiled decode step makes as many host
    launch calls with the registry and the tracer as without, 1
    ``cudaGraphLaunch`` and 2 ``cudaLaunchKernel``: the default-on
    registry adds no launch and no sync to the step."""
    eng = served.engine
    twin = serve_moe.serve(args, serve_moe.build_engine(
        args, params=eng.params, tracer=None, metrics=False))
    if twin.engine.tracer is not None or twin.engine.metrics is not None:
        fail("obs: the twin engine traces or counts")
    pairs = [(a, b) for a, b in zip(served.requests, twin.requests)
             if a.temperature == 0]
    bad = [a.request_id for a, b in pairs if a.output != b.output]
    if not pairs or bad:
        fail(f"obs: greedy requests {bad} differ between the traced serve "
             "and the untraced twin")
    keys = [set(e._graphs.graphs) for e in (eng, twin.engine)]
    for e, name in ((eng, "traced"), (twin.engine, "twin")):
        st = e.stats
        if (st.graph_captures != len(e._graphs.graphs)
                or st.graph_replays != st.steps):
            fail(f"obs: {name} engine: {st.graph_captures} captures of "
                 f"{len(e._graphs.graphs)} keys, {st.graph_replays} replays "
                 f"for {st.steps} decode steps")
    if keys[0] != keys[1]:
        fail(f"obs: the traced engine captured {len(keys[0])} keys, the "
             f"twin {len(keys[1])}: not the same")
    rows = [profile_decode(e, np.random.RandomState(5), cfg, f"obs {name}")
            for e, name in ((eng, "traced"), (twin.engine, "twin"))]
    calls = [(r["cudaGraphLaunch"], r["cudaLaunchKernel"]) for r in rows]
    if calls[0] != calls[1] or calls[0] != (1, 2):
        fail(f"obs: (cudaGraphLaunch, cudaLaunchKernel) per decode step "
             f"traced {calls[0]}, twin {calls[1]}; want (1, 2) for both")
    print(f"[obs] twin: all {len(pairs)} greedy requests give the traced "
          f"serve's tokens; {len(keys[0])} graph keys, captured once each, "
          f"in both; per decode step (cudaGraphLaunch, cudaLaunchKernel) "
          f"{calls[0]} traced and {calls[1]} untraced")
    del twin


def modelled_schedule(planner, program, seq_len: int, m_a: float,
                      m_e: float):
    """The program's graph scheduled under the planner's stage models (the
    calibrated profile) at ``seq_len``: its ``ScheduleResult``."""
    st = StageTimes.from_models(planner.stage_models(seq_len), m_a, m_e)
    return schedule(program.graph, TaskCosts.from_stage_times(st))


def comm_over_exp(spans) -> float:
    """The share of the comm lanes' busy time (A2E and E2A) that EXP
    covers, on the spans' own clock."""
    lanes = lane_intervals(spans)
    comm = interval_union(lanes.get("A2E", []) + lanes.get("E2A", []))
    busy = interval_total(comm)
    if busy <= 0:
        return 0.0
    return 1.0 - interval_total(interval_subtract(
        comm, lanes.get("EG", []))) / busy


def check_device_trace(label, program, groups, p, mcfg, x, sched) -> None:
    """``trace_dep_execution`` of one layer under ``program``: the card
    still held when the host had enqueued the walk, the spans
    in the program's walk order (GATE and ATTN are the caller's), one EXP
    per (stream, chunk), the output bitwise the untraced call's, and
    every A2E/E2A span at least its all_to_all copy's bytes bound (a
    read and a write of the chunk at the card's rate), so that the pair
    bounds the copy and not only its enqueue. Prints per-kind device ms,
    executed against scheduled exposed comm and the comm-over-EXP
    share."""
    tr = trace_dep_execution(program, groups, params=p, mcfg=mcfg, x=x,
                             device=x.device)
    if tr.host_ahead is False:
        fail(f"obs trace {label}: the card caught up with the host before "
             f"the walk was enqueued ({tr.enqueue_s * 1e3:.1f} ms on the "
             "host): the spans hold waits for the host")
    walk = [(t.kind, t.mb, t.chunk) for t in program.walk()
            if t.kind not in ("GATE", "ATTN")]
    got = [(sp.name, sp.arg("mb"), sp.arg("chunk")) for sp in tr.spans]
    if got != walk:
        fail(f"obs trace {label}: spans {got} are not the walk {walk}")
    g = program.graph
    exp = [(mb, c) for k, mb, c in got if k == "EXP"]
    if sorted(exp) != [(i, j) for i in range(g.r1) for j in range(g.r2)]:
        fail(f"obs trace {label}: EXP spans at {exp}, want one per "
             f"(stream, chunk) of r1={g.r1} x r2={g.r2}")
    if not torch.equal(tr.out, tr.untraced()):
        fail(f"obs trace {label}: the traced layer is not bitwise the "
             "untraced one")
    E, M = p["experts"]["gate"].shape[0], x.shape[-1]
    cap = moe_lib.expert_capacity(x.shape[0] * x.shape[1], mcfg,
                                  multiple_of=program.capacity_multiple)
    C = cap // (g.r1 * g.r2)
    copy_bound_s = 2 * E * C * M * x.element_size() / HBM_BYTES_PER_S
    for sp in tr.spans:
        if not 0 <= sp.start <= sp.end:
            fail(f"obs trace {label}: span {sp} out of order")
        if sp.name in ("A2E", "E2A") and sp.duration < copy_bound_s:
            fail(f"obs trace {label}: {sp.name} mb={sp.arg('mb')} "
                 f"chunk={sp.arg('chunk')} took {sp.duration * 1e3:.4f} ms, "
                 f"under its copy's bound {copy_bound_s * 1e3:.4f} ms: the "
                 "events do not bound the all_to_all")
    per_kind = {}
    for sp in tr.spans:
        per_kind[sp.name] = per_kind.get(sp.name, 0.0) + sp.duration * 1e3
    rep = attribute_overlap(tr.spans, sched)
    row = dict(program=describe(program), x=list(x.shape), capacity=cap,
               chunk=C, chunk_mb=E * C * M * x.element_size() / 1e6,
               spans=len(tr.spans), per_kind_ms=per_kind,
               makespan_ms=rep.makespan_executed * 1e3,
               exposed_executed_ms={k: v * 1e3 for k, v in
                                    rep.exposed_executed.items()},
               exposed_scheduled_ms={k: v * 1e3 for k, v in
                                     rep.exposed_modeled.items()},
               exposed_frac_executed=rep.exposed_frac_executed,
               exposed_frac_scheduled=rep.exposed_frac_modeled,
               makespan_scheduled_ms=rep.makespan_modeled * 1e3,
               comm_over_exp=comm_over_exp(tr.spans),
               copy_bound_ms=copy_bound_s * 1e3, wall_s=tr.wall_s,
               enqueue_ms=tr.enqueue_s * 1e3, host_ahead=tr.host_ahead)
    print(f"[obs trace] {label} {row['program']} x{row['x']}, capacity "
          f"{cap} ({C} a chunk, {row['chunk_mb']:.1f} MB): device ms by "
          "kind " + ", ".join(f"{k} {v:.4f}" for k, v in per_kind.items())
          + f"; makespan {row['makespan_ms']:.4f} ms; exposed comm "
          f"executed {row['exposed_executed_ms']['total']:.4f} ms "
          f"({row['exposed_frac_executed']:.1%}) beside scheduled "
          f"{row['exposed_scheduled_ms']['total']:.4f} ms "
          f"({row['exposed_frac_scheduled']:.1%} of a modelled "
          f"{row['makespan_scheduled_ms']:.4f} ms); comm under EXP "
          f"{row['comm_over_exp']:.1%}; in walk order, one EXP per "
          "(stream, chunk), bitwise the untraced layer " + json.dumps(row))


def phase_obs(profile, store_dir: str) -> None:
    """The observability path. Serves full qwen2-moe-a2.7b through the
    port's entry point (``serve_moe.main``: --full --dep, 16 requests, 8
    slots, max_context 1024, on the calibrate phase's profile, with
    --trace-out and --metrics-out), reads both files back
    (``check_obs_outputs``) and holds the traced engine against an
    untraced twin (``check_obs_twin``). Then traces one MoE layer of the
    served weights on the card (``trace_dep_execution``: CUDA event pairs
    on the comm and compute streams) under the 8 x 300 prefill's planned
    program and the forced r1 = 2 x r2 = 4 one, each interleaved and not
    (``check_device_trace``). Prints its wall time."""
    t0 = time.perf_counter()
    cfg = get_config("qwen2-moe-a2.7b")
    out_dir = tempfile.mkdtemp(dir=store_dir)
    argv = ["--full", "--dep", "--device", OBS_DEVICE, "--requests", "16",
            "--slots", "8", "--max-context", "1024",
            "--profile", profile.name, "--profile-store", store_dir,
            "--trace-out", os.path.join(out_dir, "trace.json"),
            "--metrics-out", os.path.join(out_dir, "metrics.jsonl")]
    served = serve_moe.main(argv)
    args = serve_moe.build_parser().parse_args(argv)
    eng = served.engine
    if eng.plan_policy.planner.hardware != profile:
        fail("obs: the entry point did not plan on the calibrate phase's "
             "profile")
    check_obs_outputs(served, args)
    check_obs_twin(served, args, cfg)
    p, groups = eng.params["layers"][0]["moe"], eng.model.ctx.groups
    del served, eng
    torch.cuda.empty_cache()
    planner = dep_policy(cfg, profile).planner
    plan = dep_policy(cfg, profile).resolve("prefill", 512, 8)
    chunk, n_mb = prefill_split(plan, 8)
    gen = torch.Generator(device=OBS_DEVICE)
    gen.manual_seed(9)
    for interleave in ("streams", "off"):
        cases = (("planned 8 x 300 prefill",
                  plan.exec_program(streams=n_mb, interleave=interleave),
                  chunk, plan.m_a, plan.m_e),
                 ("forced", ExecProgram(forced_program().graph, interleave),
                  8, 4.0, None))
        for label, prog, B, m_a, m_e in cases:
            x = torch.randn((B, 512, cfg.d_model), generator=gen,
                            device=OBS_DEVICE).to(torch.bfloat16)
            if m_e is None:
                m_e = planner.stage_models(512).me_from_ma(m_a, prog.graph.r2)
            sched = modelled_schedule(planner, prog, 512, m_a, m_e)
            check_device_trace(f"{label} ({interleave})", prog, groups, p,
                               cfg.moe, x, sched)
            del x
    del p, groups
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 0.5:
        fail(f"obs: {left:.2f} GB still allocated after the phase: an "
             "engine outlived it")
    torch.cuda.empty_cache()
    print(f"[obs] phase passed in {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4e: the paper's two backbones (MLA; 128 experts)
# ---------------------------------------------------------------------------

#: qwen3-moe layers served on one card: each holds 2.45 B parameters
#: (128 x 3 x 4096 x 1536 expert weights), so 8 of its 48 layers and the
#: 151936-token embedding and head come to 20.9 B (41.7 GB in bf16)
QWEN3_LAYERS = 8
#: deepseek-v2-lite layers served: 14 of its 27 (each an MLA + MoE layer),
#: cut to keep the whole run within its time with room to spare
MLA_LAYERS = 14
#: command-r-35b layers served: 16 of its 40 (all 40 hold 30.3 B params,
#: 60.6 GB of bf16 weights: they fit the card, but not the run's time)
COMMAND_R_LAYERS = 16
#: the repo's other configurations served at full width: path -> (config,
#: layers served; None keeps its depth)
SERVED = {"granite": ("granite-moe-1b-a400m", None),
          "qwen2-1.5b": ("qwen2-1.5b", None),
          "starcoder2": ("starcoder2-3b", None),
          "command-r": ("command-r-35b", COMMAND_R_LAYERS)}
#: starcoder2's KV positions a slot and the prompt that passes its 4096
#: window (``served_requests``)
STARCODER_CONTEXT = 5120
STARCODER_LONG = 4608


def backbone_config(path: str):
    """The config of a backbone path: "mla" serves deepseek-v2-lite at
    full width cut to ``MLA_LAYERS``, "qwen3" qwen3-moe cut to
    ``QWEN3_LAYERS``, a path of ``SERVED`` its config at full width and
    the depth it names."""
    if path in SERVED:
        arch, layers = SERVED[path]
        cfg = get_config(arch)
        return cfg if layers is None else dataclasses.replace(
            cfg, num_layers=layers)
    if path == "mla":
        return dataclasses.replace(get_config("deepseek-v2-lite"),
                                   num_layers=MLA_LAYERS)
    return dataclasses.replace(get_config("qwen3-moe"),
                               num_layers=QWEN3_LAYERS)


def served_context(cfg) -> int:
    """KV positions a slot of a served path: ``STARCODER_CONTEXT`` under a
    sliding window (its prompt past the window fits), else 1024."""
    return STARCODER_CONTEXT if is_ring(cfg) else 1024


def check_flash_shape(gen, label: str, B: int, S: int, H: int, Kv: int,
                      D: int, window=None) -> dict:
    """bf16 flash at a serve path's prefill shape against its plain
    version (``FLASH_TOL``, beside the off-by-one controls); the kernel,
    the plain version (CUDA events: its device events per call vary
    with the shape) and ``F.scaled_dot_product_attention`` (K/V repeated
    to H heads beforehand; with a ``window``, its band as a boolean mask)
    timed, and the card's bound (the window's keys only)."""
    dtype = torch.bfloat16
    q = randn(gen, (B, S, H, D), dtype)
    k = randn(gen, (B, S, Kv, D), dtype)
    v = randn(gen, (B, S, Kv, D), dtype)
    name = f"{label} B={B} S={S} H={H} Kv={Kv} D={D}" + (
        f" window={window}" if window else "") + " bf16"
    got = flash_attention(q, k, v, window=window)
    err = compare(name, got, flash_attention_ref(q, k, v, window=window),
                  dtype, FLASH_TOL[dtype])
    ctrl = check_flash_controls(name, got, q, k, v, window=window)
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.transpose(1, 2).repeat_interleave(H // Kv, dim=1)
              .contiguous() for t in (k, v))
    plain = time_ms(lambda: flash_attention_ref(q, k, v, window=window),
                    iters=5)
    if window is None:
        ms, dev = timed(lambda: flash_attention(q, k, v), "flash_attention_")
        lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        how = "device"
    else:
        # calls of a millisecond and more (the long phase's prompt) time as
        # CUDA events around back-to-back calls: late in a run the profiler
        # has lost nine of ten such calls' events from every trace
        i = torch.arange(S, device=q.device)
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def kern():
            return flash_attention(q, k, v, window=window)

        def lib_fn():
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
        ms, dev = time_ms(kern), back_to_back_ms(kern)
        lib, lib_dev = time_ms(lib_fn), back_to_back_ms(lib_fn)
        del band
        how = "back to back"
    flops, nbytes = flash_attention_work(q, k, v, True, window)
    b, by = bound_ms(nbytes, flops, dtype)
    if window is not None and min(dev, lib_dev) < b:
        fail(f"{name}: a time below the card's bound {b:.4f} ms")
    print(f"  {name}: kernel {ms:.4f} ms events, {dev:.4f} ms {how} "
          f"({flops / dev / 1e9:.1f} TFLOP/s); plain {plain:.3f} ms events; "
          f"F.scaled_dot_product_attention {lib:.4f} / {lib_dev:.4f} ms "
          f"({how}); bound {b:.4f} ms ({by})")
    return dict(shape=name, max_abs_err=err, control_worst_ratio=ctrl,
                ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=b, bound_by=by)


def check_decode_shape(gen, label: str, H: int, Kv: int, D: int,
                       C: int = 1024, serve: tuple = (290, 311)) -> dict:
    """bf16 split-KV decode at a serve path's decode shape (8 rows of C
    cache positions) against its plain version (``DECODE_TOL``, beside the
    controls) at mixed lengths and at lengths drawn from ``serve`` (the
    path's [low, high) at decode: by default ~300, the decode profile's);
    timed at the latter (``time_decode``)."""
    dtype, B = torch.bfloat16, 8
    mixed = np.array([0, 1, C, 37, C * 500 // 1024, C - 24, 33,
                      C * 613 // 1024])
    serve_lens = np.random.RandomState(5).randint(*serve, size=B)
    errs = {}
    for tag, lens in (("mixed", mixed), (f"~{sum(serve) // 2}",
                                         serve_lens)):
        lt = torch.tensor(lens, dtype=torch.int32, device="cuda")
        q, k, v = _decode_inputs(gen, B, H, Kv, D, C, dtype)
        name = f"{label} B={B} H={H} Kv={Kv} D={D} C={C} {tag} bf16"
        out = decode_attention(q, k, v, lt)
        errs[tag] = compare(name, out, decode_attention_ref(q, k, v, lt),
                            dtype, DECODE_TOL[dtype])
        check_decode_controls(name, out, q, k, v, lt)
    timing = time_decode(name, q, k, v, lt)
    return dict(timing, shape=name, max_abs_err=errs[tag],
                mixed_max_abs_err=errs["mixed"],
                lengths=serve_lens.tolist())


def time_gemm_shapes(gen, path: str, cfg, S: int, experts: int = 0,
                     widths=None) -> dict:
    """The expert GEMM at the path's (E, M, H), on weights at
    ``check_moe_gemm``'s scale, at its two regimes: a decode step of 8
    slots and the 8 x S prefill call, each against its plain version
    (``GEMM_TOL``, beside the controls) and timed beside the plain version
    (CUDA events) and ``torch.bmm`` x3 + SiLU, with the card's bound.
    ``experts`` (a rank's share) and ``widths`` ({regime: C}) override E
    and the capacities."""
    E, M, H = cfg.moe.num_experts, cfg.d_model, cfg.moe.expert_ffn_dim
    E = experts or E
    wg = randn(gen, (E, M, H), torch.bfloat16, M ** -0.5)
    wu = randn(gen, (E, M, H), torch.bfloat16, M ** -0.5)
    wd = randn(gen, (E, H, M), torch.bfloat16, H ** -0.5)
    out = {}
    widths = widths or {
        regime: moe_lib.expert_capacity(tokens, cfg.moe)
        for regime, tokens in (("decode", 8), ("prefill", 8 * S))}
    for regime, C in widths.items():
        x = randn(gen, (E, C, M), torch.bfloat16)
        name = f"{path} {regime} E={E} C={C} M={M} H={H} bf16"
        got, want = moe_gemm(x, wg, wu, wd), moe_gemm_ref(x, wg, wu, wd)
        err = compare(name, got, want, torch.bfloat16,
                      GEMM_TOL[torch.bfloat16])
        ctrl = check_moe_gemm_controls(name, got, x, wg, wu, wd, want)
        del got, want
        ms, dev = timed(lambda: moe_gemm(x, wg, wu, wd), "moe_gemm_")
        plain = time_ms(lambda: moe_gemm_ref(x, wg, wu, wd), iters=5)
        lib, lib_dev = timed(lambda: torch.bmm(
            F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd))
        flops, nbytes = moe_gemm_work(x, wg, wu, wd)
        b, by = bound_ms(nbytes, flops, torch.bfloat16)
        print(f"  {name}: kernel {ms:.3f} ms events, {dev:.4f} ms device "
              f"({nbytes / dev / 1e9:.3f} TB/s, {flops / dev / 1e9:.1f} "
              f"TFLOP/s); plain {plain:.3f} ms events; torch.bmm x3 "
              f"{lib:.3f} / {lib_dev:.4f} ms; bound {b:.4f} ms ({by})")
        out[regime] = dict(shape=name, max_abs_err=err,
                           control_worst_ratio=ctrl, ms=ms,
                           device_ms=dev, plain_ms=plain, library_ms=lib,
                           library_device_ms=lib_dev, bound_ms=b,
                           bound_by=by)
        del x
    del wg, wu, wd
    torch.cuda.empty_cache()
    return out


def plain_attention(q, k, v):
    """Plain softmax attention of every query over every key, f32 logits
    (Sk may differ from Sq): the controls' reference."""
    B, Sq, H, D = q.shape
    Kv = k.shape[2]
    qh = q.reshape(B, Sq, Kv, H // Kv, D).float()
    p = torch.softmax(torch.einsum("bqkgd,bskd->bkgqs", qh, k.float())
                      / D ** 0.5, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)


def check_row_controls(name: str, got, wrongs: dict, tol) -> float:
    """Every control (label -> the plain output of a wrong function) must
    fail ``tol`` in every batch row it changes. Returns the least of the
    rows' worst ratios."""
    g = got.float()
    ratios = {}
    for label, (w, changed) in wrongs.items():
        w = w.float()
        per_row = ((g - w).abs() / (tol["atol"] + tol["rtol"] * w.abs())) \
            .flatten(1).amax(1)
        ratios[label] = float(per_row[changed].min())
    print(f"  {name} controls (least over the rows each changes): " +
          ", ".join(f"{label} {r:.1f}x the limit"
                    for label, r in ratios.items()))
    for label, r in ratios.items():
        if r <= 1:
            fail(f"{name}: the control {label} passes the limit in a row: "
                 "the check cannot see that fault there")
    return min(ratios.values())


def check_flash_bidirectional(gen) -> dict:
    """The encoder's self-attention at seamless-m4t-large-v2's shape (8
    rows of its 1024 frames, H = Kv = 16, D = 64) through the flash
    kernel with ``causal=False``: f32 at ``TOL`` (the SIMT kernel), bf16
    at ``FLASH_TOL`` (the wgmma kernel) beside two controls that must fail
    ``FLASH_TOL`` in every batch row, the plain version with the last key
    dropped and with a causal mask; timed beside the plain version and
    ``F.scaled_dot_product_attention(is_causal=False)``, with the bound
    (no mask: every query does S keys)."""
    cfg = get_config("seamless-m4t-large-v2")
    B, S, H, Kv, D = (8, cfg.frontend_tokens, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = randn(gen, (B, S, H, D), dtype)
        k = randn(gen, (B, S, Kv, D), dtype)
        v = randn(gen, (B, S, Kv, D), dtype)
        name = f"encoder B={B} S={S} H={H} Kv={Kv} D={D} causal=False " \
               f"{dtype}"
        got = flash_attention(q, k, v, causal=False)
        out[dtype] = compare(name, got,
                             flash_attention_ref(q, k, v, causal=False),
                             dtype, FLASH_TOL[dtype])
    every = torch.ones(B, dtype=torch.bool, device="cuda")
    ctrl = check_row_controls(name, got, {
        "last key dropped": (plain_attention(q, k[:, :-1], v[:, :-1]),
                             every),
        "causal mask": (flash_attention_ref(q, k, v, causal=True), every)},
        FLASH_TOL[torch.bfloat16])
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    ms, dev = timed(lambda: flash_attention(q, k, v, causal=False),
                    "flash_attention_")
    plain = time_ms(lambda: flash_attention_ref(q, k, v, causal=False),
                    iters=5)
    lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=False))
    flops, nbytes = flash_attention_work(q, k, v, False)
    b, by = bound_ms(nbytes, flops, torch.bfloat16)
    print(f"  {name}: kernel {ms:.4f} ms events, {dev:.4f} ms device "
          f"({flops / dev / 1e9:.1f} TFLOP/s); plain {plain:.3f} ms events; "
          f"F.scaled_dot_product_attention {lib:.4f} / {lib_dev:.4f} ms; "
          f"bound {b:.4f} ms ({by})")
    return dict(shape=name, max_abs_err=out[torch.bfloat16],
                f32_max_abs_err=out[torch.float32], control_worst_ratio=ctrl,
                ms=ms, device_ms=dev, plain_ms=plain, library_ms=lib,
                library_device_ms=lib_dev, bound_ms=b, bound_by=by)


def check_cross_decode(gen) -> dict:
    """Cross-attention at decode through the dense decode kernels: one
    query a row against seamless-m4t-large-v2's memory (8 rows, C = the
    1024 frames, H = Kv = 16, D = 64), every length C. f32 at ``TOL``,
    bf16 at ``DECODE_TOL`` beside the controls (a length one shorter, chunk
    1 read one position late; one longer changes nothing at C); timed as
    ``time_decode`` does, and beside an unmasked
    ``F.scaled_dot_product_attention``."""
    cfg = get_config("seamless-m4t-large-v2")
    B, C, H, Kv, D = (8, cfg.frontend_tokens, cfg.num_heads,
                      cfg.num_kv_heads, cfg.head_dim)
    lt = torch.full((B,), C, dtype=torch.int32, device="cuda")
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _decode_inputs(gen, B, H, Kv, D, C, dtype)
        name = f"cross B={B} H={H} Kv={Kv} D={D} C={C} every length {C} " \
               f"{dtype}"
        got = decode_attention(q, k, v, lt)
        errs[dtype] = compare(name, got, decode_attention_ref(q, k, v, lt),
                              dtype, DECODE_TOL[dtype])
    ctrl = check_decode_controls(name, got, q, k, v, lt)
    timing = time_decode(name, q, k, v, lt)
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    lib, lib_dev = timed(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kt, vt, is_causal=False))
    print(f"  {name}: F.scaled_dot_product_attention without a mask "
          f"{lib:.4f} / {lib_dev:.4f} ms")
    return dict(timing, shape=name, max_abs_err=errs[torch.bfloat16],
                f32_max_abs_err=errs[torch.float32], control_worst_ratio=ctrl,
                library_masked_ms=timing["library_ms"],
                library_masked_device_ms=timing["library_device_ms"],
                library_ms=lib, library_device_ms=lib_dev)


def check_backbone_kernels(gen) -> dict:
    """Each backbone path's kernels at the shapes its serve gives them:
    flash at the 8 x 300 prefill's bucket (MLA: H = Kv), split-KV decode
    at 8 slots (GQA only: MLA decodes through the plain SDPA) and the
    expert GEMM at decode and prefill; each against its plain version
    beside its controls, timed. Runs in the kernel phase, before the
    serve phases' profiles, while the profiler keeps every device event
    of a short trace (late in a run it drops some). Returns {path:
    {kernel name: entry}}."""
    out = {}
    for path in ("mla", "qwen3"):
        cfg = backbone_config(path)
        print(f"[kernels] {path} ({cfg.name}) shapes")
        H, D = cfg.num_heads, cfg.head_dim
        Kv = H if cfg.mla_kv_lora_rank else cfg.num_kv_heads
        S = bucket_length(300)
        out[path] = {
            "flash_attention": check_flash_shape(gen, f"{path} prefill", 8,
                                                 S, H, Kv, D),
            "moe_gemm": time_gemm_shapes(gen, path, cfg, S)}
        if decode_kernel_of(cfg):
            out[path]["decode_attention"] = check_decode_shape(
                gen, f"{path} decode", H, Kv, D)
    # the ep phase's expert rank: 30 of qwen2-moe's 60 experts, at a
    # decode step's width and two of its prefill calls' (m_e-aligned)
    print("[kernels] ep (one expert rank of qwen2-moe-a2.7b) shapes")
    out["ep"] = {"moe_gemm": time_gemm_shapes(
        gen, "ep", get_config("qwen2-moe-a2.7b"), 0,
        experts=get_config("qwen2-moe-a2.7b").moe.num_experts // EP_RANKS,
        widths=EP_GEMM_WIDTHS)}
    print("[kernels] multimodal (internvl2-1b, seamless-m4t-large-v2) "
          "shapes")
    out["multimodal"] = check_multimodal_shapes(gen)
    out.update(check_served_kernels(gen))
    torch.cuda.empty_cache()
    return out


def check_served_kernels(gen) -> dict:
    """The kernels of each ``SERVED`` path at the shapes its serve gives
    them: flash at the 8 x 300 prefill's bucket (starcoder2: with its
    4096 window, and at its long prompt's bucket, where the window
    bites), split-KV decode at 8 slots of 1024 positions (none over
    starcoder2's ring), the expert GEMM at granite's decode and prefill
    C; each against its plain version beside its controls, timed beside
    the plain version and the library call, with the card's bound.
    Returns {path: {kernel name: {regime: entry}}}."""
    out = {}
    for path in SERVED:
        cfg = backbone_config(path)
        H, Kv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        window = cfg.sliding_window if is_ring(cfg) else None
        print(f"[kernels] {path} ({cfg.name}) shapes")
        S = bucket_length(300)
        flash = {"prefill": check_flash_shape(gen, f"{path} prefill", 8, S,
                                              H, Kv, D, window=window)}
        if window is not None:
            flash["long prefill"] = check_flash_shape(
                gen, f"{path} long prefill", 1,
                min(bucket_length(STARCODER_LONG), served_context(cfg)), H,
                Kv, D, window=window)
        out[path] = {"flash_attention": flash}
        if decode_kernel_of(cfg):
            out[path]["decode_attention"] = {"decode": check_decode_shape(
                gen, f"{path} decode", H, Kv, D)}
        if cfg.is_moe:
            out[path]["moe_gemm"] = time_gemm_shapes(gen, path, cfg, S)
        torch.cuda.empty_cache()
    return out


def check_multimodal_shapes(gen) -> dict:
    """The multimodal phase's attention at the shapes its serve gives the
    kernels: the seamless encoder (flash, ``causal=False``) and its
    cross-attention at decode (the dense decode kernels, every length the
    frame count); each decoder's causal flash at prefill (internvl2: the
    P patches and the prompt, g = 7; seamless: the prompt) and its
    split-KV decode over the cache the serve steps grow (the prefill's
    length + ``MM_STEPS``, live lengths from one past the prefill to C).
    Returns {kernel name: {shape label: entry}}."""
    flash = {"encoder": check_flash_bidirectional(gen)}
    decode = {"cross": check_cross_decode(gen)}
    for arch, label in (("internvl2-1b", "internvl2"),
                        ("seamless-m4t-large-v2", "seamless")):
        cfg = get_config(arch)
        H, Kv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        S = MM_PROMPT + (0 if cfg.is_encoder_decoder
                         else cfg.frontend_tokens)
        flash[f"{label} prefill"] = check_flash_shape(
            gen, f"{label} prefill", MM_BATCH, S, H, Kv, D)
        decode[f"{label} decode"] = check_decode_shape(
            gen, f"{label} decode", H, Kv, D, C=S + MM_STEPS,
            serve=(S + 1, S + MM_STEPS + 1))
    return {"flash_attention": flash, "decode_attention": decode}


def time_mla_recompute(attn_params, cfg, decode_row: dict) -> dict:
    """One MLA layer's decode-step attention on the card at the mla
    path's decode shape (8 slots, C = 1024, ~300 live positions): the
    ``w_ukv`` GEMM over the whole latent cache, the recompute with
    ``kpe`` added (``attention._cached_kv``) and the plain masked SDPA
    over its output; time per layer (CUDA events around 20 back-to-back
    calls) and x ``num_layers`` per step, beside the expert GEMM's per
    step from the decode profile, and the card's bound for the GEMM (the
    latent read, [B, C, 2 H D] written)."""
    from repro_torch.models import attention as attn_lib
    from repro_torch.models.layers import dense_apply
    B, C, L = 8, 1024, cfg.num_layers
    r, H, D = cfg.mla_kv_lora_rank, cfg.num_heads, cfg.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    cache = {"ckv": randn(gen, (B, C, r), torch.bfloat16),
             "kpe": randn(gen, (B, C, D), torch.bfloat16)}
    q = randn(gen, (B, 1, H, D), torch.bfloat16)
    lens = torch.tensor(np.random.RandomState(5).randint(290, 311, size=B),
                        dtype=torch.int32, device="cuda")
    mask = (torch.arange(C, device="cuda")[None, None, :]
            < lens[:, None, None])
    k_all, v_all = attn_lib._cached_kv(attn_params, cfg, cache,
                                       torch.bfloat16)
    parts = {
        "w_ukv GEMM": lambda: dense_apply(attn_params["w_ukv"],
                                          cache["ckv"]),
        "recompute (GEMM, split, + kpe)": lambda: attn_lib._cached_kv(
            attn_params, cfg, cache, torch.bfloat16),
        "SDPA (f32 logits, mask)": lambda: attn_lib._sdpa(q, k_all, v_all,
                                                          mask),
    }
    out = {}
    for label, fn in parts.items():
        ms = back_to_back_ms(fn)
        out[label] = dict(ms=ms, step_ms=ms * L)
    nbytes = (B * C * r + r * 2 * H * D + B * C * 2 * H * D) * 2
    b, by = bound_ms(nbytes, 2.0 * B * C * r * 2 * H * D, torch.bfloat16)
    out["w_ukv GEMM"].update(bound_ms=b, bound_by=by)
    print(f"[mla recompute] one layer at B={B} C={C} r={r} H={H} D={D} "
          f"bf16, ms per layer (x{L} per decode step): " + ", ".join(
              f"{label} {v['ms']:.4f} ({v['step_ms']:.2f})"
              for label, v in out.items())
          + f"; the w_ukv GEMM's bound {b:.4f} ms ({by}); the expert GEMM "
          f"{decode_row.get('moe_gemm_ms', float('nan')):.2f} ms and all "
          f"kernels {decode_row.get('kernel_ms', float('nan')):.2f} ms per "
          "graph step in the decode profile")
    return out


def phase_backbone(path: str, profile):
    """One of the paper's backbones at full width on the card, bf16
    weights from seed 0, 8 slots, max_context 1024, ``mixed_requests``:
    "mla" serves deepseek-v2-lite cut to ``MLA_LAYERS`` layers (MLA, 64
    experts top-6 + 2 shared), "qwen3" qwen3-moe cut to ``QWEN3_LAYERS``
    layers (GQA 64/4,
    128 experts top-8). The capacity engine serves, then a DEP engine on
    the same weights (FinDEP on the calibrate phase's profile, the NCCL
    group of one rank). Each: launches checked at every step (the expert
    GEMM L x (steps + prefill calls) on capacity and L x Σ r1·r2 on DEP,
    flash L per prefill call, split-KV decode L per step under GQA and
    none under MLA), graph against eager (greedy tokens, 11
    teacher-forced steps bitwise), a decode and a prefill profile; a
    paired decode timing of the three engines; the expert GEMM against
    its plain version at every (E, C) both serves gave it; under MLA the
    decode recompute timed; on a ``SERVED`` path (granite) the f32
    readout (``time_readout``), and no eager twin of the DEP engine. Returns the launch counts of the two
    serves and {"recompute": under MLA the recompute's times, "readout":
    on a ``SERVED`` path the readout's}, each only where it ran."""
    cfg = backbone_config(path)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    groups = DepGroups.single(DEP_BACKEND)
    t0 = time.perf_counter()
    cap = ServingEngine(cfg, num_slots=8, max_context=1024,
                        dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    params = cap.params
    n_params = sum(t.numel() for t in _leaves(params))
    m = cfg.moe
    attn_desc = (f"MLA kv_lora_rank {cfg.mla_kv_lora_rank}"
                 if cfg.mla_kv_lora_rank
                 else f"GQA {cfg.num_heads}/{cfg.num_kv_heads}")
    print(f"[{path}] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, "
          f"{attn_desc}, {m.num_experts} experts top-{m.top_k} (H "
          f"{m.expert_ffn_dim}) + {m.num_shared_experts} shared, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params drawn in bf16 "
          f"on the card in {time.perf_counter() - t0:.1f} s "
          f"(ModelConfig.num_params() says {cfg.num_params() / 1e9:.3f} B)")

    def dep_engine(**kw):
        return ServingEngine(cfg, params=params, num_slots=8,
                             max_context=1024, dtype=torch.bfloat16, seed=0,
                             plan_policy=dep_policy(cfg, profile),
                             ep_group=groups, **kw)

    prompts = np.random.RandomState(8).randint(0, cfg.vocab_size,
                                               size=(8, 300))
    counts, results = {}, {}
    dep_path = f"{path} dep"
    with GemmWidths() as rec:
        expect = moe_expect(cfg, decode_kernel_of(cfg))
        reqs = mixed_requests(cfg)
        results[path] = {}
        counts[path] = serve(cap, reqs, cfg, path, expect,
                             step_check=launches_per_step(cap, path, expect),
                             into=results[path])
        decode_row = profile_decode(cap, np.random.RandomState(5), cfg,
                                    path)
        profile_prefill(cap, prompts, path)
        eager = ServingEngine(cfg, params=params, num_slots=8,
                              max_context=1024, dtype=torch.bfloat16, seed=0,
                              decode_graph=False)
        against_eager(path, cap, eager, cfg, reqs,
                      lambda: mixed_requests(cfg), expect,
                      forced_prompts(cfg.vocab_size))

        dep = dep_engine()
        expect = dep_expect(cfg)
        reqs = mixed_requests(cfg)
        step_check = launches_per_step(dep, dep_path, expect)
        results[dep_path] = {}
        counts[dep_path] = serve(dep, reqs, cfg, dep_path, expect,
                                 step_check=step_check,
                                 into=results[dep_path])
        print(f"[{dep_path}] every kernel launched as its step asked at all "
              f"{step_check.steps} steps: the expert GEMM {cfg.num_layers} "
              "x sum(r1*r2) of the step's programs")
        print_plans(dep, dep_path)
        profile_decode(dep, np.random.RandomState(5), cfg, dep_path)
        chunk, _ = prefill_split(dep_policy(cfg, profile).resolve(
            "prefill", bucket_length(300), 8), 8)
        profile_prefill(dep, prompts, dep_path, calls=-(-8 // chunk))
        if path not in SERVED:
            # a SERVED path holds its capacity engine against eager only:
            # the DEP twin's serve is cut for the run's time
            dep_eager = dep_engine(decode_graph=False)
            against_eager(dep_path, dep, dep_eager, cfg, reqs,
                          lambda: mixed_requests(cfg), expect,
                          forced_prompts(cfg.vocab_size))
            del dep_eager
    compare_decode({"capacity graph": cap, "capacity eager": eager,
                    "dep graph": dep}, cfg)
    del eager
    torch.cuda.empty_cache()
    experts = params["layers"][0]["moe"]["experts"]
    check_dep_widths({experts["gate"].shape[0]: experts}, rec.shapes,
                     cap.device, path)
    extra = {}
    if cfg.mla_kv_lora_rank:
        extra["recompute"] = time_mla_recompute(params["layers"][0]["attn"],
                                                cfg, decode_row)
    if path in SERVED:
        extra["readout"] = time_readout(cap.model, params, cfg, path,
                                        decode_row)
    for name, res in results.items():
        print(f"[{path} summary] {name}: {n_params / 1e9:.3f} B params "
              f"(num_params() {cfg.num_params() / 1e9:.3f} B), "
              f"{res['tokens_per_s']:.1f} tokens/s, decode step "
              f"{res['decode_step_ms']:.2f} ms, prefill call "
              f"{res['prefill_ms_mean']:.1f} ms, peak "
              f"{res['peak_mem_gb']:.2f} GB allocated, serve wall "
              f"{res['wall_s']:.2f} s")
    del cap, dep, params, experts, rec
    check_freed(path)
    return counts, extra


def check_freed(path: str) -> None:
    """Fail if 0.5 GB or more is still allocated after a serve path (an
    engine outlived it)."""
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 0.5:
        fail(f"{path}: {left:.2f} GB still allocated after the phase: an "
             "engine outlived it")
    torch.cuda.empty_cache()


def time_readout(model, params, cfg, path: str, decode_row: dict) -> dict:
    """The f32 readout of a decode step on its own (8 rows through
    ``Model._readout``: the whole table cast to f32, then an f32 GEMM, as
    the reference computes it): its time as CUDA events around
    back-to-back calls (``back_to_back_ms``: a call of 0.28 ms and more,
    and late in a run the profiler drops whole traces of it), its
    kernels by name (torch.profiler over 5 calls; what the trace kept),
    its share of the decode profile's kernel ms, and two times at the
    card's memory rate: the bytes it moves (the table read in its dtype,
    written and read back in f32) and the table read once in its
    dtype."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    x = randn(gen, (8, 1, cfg.d_model), model.dtype)

    def fn():
        return model._readout(params, x)

    ms = back_to_back_ms(fn)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in device_events(prof):
        us, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    kernels = {name[:90]: dict(ms=us / 1e3 / 5, per_call=n / 5)
               for name, (us, n) in by_name.items()}
    table = (params["embed"]["embedding"] if cfg.tie_embeddings
             else params["lm_head"]["kernel"])
    moved = table.numel() * (table.element_size() + 8)
    once = table.numel() * table.element_size()
    row = dict(ms=ms, kernels=kernels,
               share_of_decode_kernel_ms=ms / decode_row["kernel_ms"],
               decode_kernel_ms=decode_row["kernel_ms"],
               bytes_moved_gb=moved / 1e9,
               bytes_moved_ms=moved / HBM_BYTES_PER_S * 1e3,
               table_once_ms=once / HBM_BYTES_PER_S * 1e3)
    if ms < row["table_once_ms"]:
        fail(f"readout {path}: {ms:.4f} ms is below the table's one read "
             f"at the card's rate, {row['table_once_ms']:.4f} ms")
    print(f"[readout {path}] {tuple(table.shape)} {table.dtype} table, 8 "
          f"rows: {ms:.3f} ms back to back, "
          f"{row['share_of_decode_kernel_ms']:.1%} "
          f"of the decode step's {decode_row['kernel_ms']:.2f} kernel ms; "
          f"{moved / 1e9:.2f} GB moved ({row['bytes_moved_ms']:.3f} ms at "
          f"the card's rate), the table read once {row['table_once_ms']:.3f}"
          f" ms; by kernel: " + "; ".join(
              f"{name} {v['ms']:.3f} ms x{v['per_call']:g}"
              for name, v in kernels.items()))
    return row


def served_requests(cfg):
    """``mixed_requests``; under a sliding window the last one (greedy)
    has a prompt of ``STARCODER_LONG`` tokens (``RandomState(9)``), past
    the window, so the window bites at prefill and in every decode
    step."""
    reqs = mixed_requests(cfg)
    if is_ring(cfg):
        rng = np.random.RandomState(9)
        reqs[-1] = Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                   size=STARCODER_LONG)),
                           max_new_tokens=32)
    return reqs


def phase_served(path: str) -> tuple:
    """A dense ``SERVED`` path at full width on the card, bf16 weights
    from seed 0, 8 slots, ``served_context`` positions a slot,
    ``served_requests``: the graph engine serves with the launches
    checked at every step (``moe_expect``), profiled over 3 decode
    steps and one 8 x 300 prefill call, the f32 readout timed alone;
    then an eager twin on the same weights (greedy tokens equal, 11
    teacher-forced steps bitwise; under the window a 4094-token prompt
    whose ring wraps during them). Returns the serve's launch counts and
    the readout's row."""
    cfg = backbone_config(path)
    C = served_context(cfg)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, num_slots=8, max_context=C,
                        dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    window = (f", sliding window {cfg.sliding_window} over a ring"
              if is_ring(cfg) else "")
    print(f"[{path}] {cfg.name}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, GQA {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}{window}, d_ff {cfg.ffn_dim}, vocab "
          f"{cfg.vocab_size} ({'tied' if cfg.tie_embeddings else 'untied'}"
          f"); {n_params / 1e9:.3f} B params drawn in bf16 on the card in "
          f"{time.perf_counter() - t0:.1f} s (ModelConfig.num_params() says "
          f"{cfg.num_params() / 1e9:.3f} B); max_context {C}")
    expect = moe_expect(cfg, decode_kernel_of(cfg))
    reqs = served_requests(cfg)
    res = {}
    counts = serve(eng, reqs, cfg, path, expect,
                   step_check=launches_per_step(eng, path, expect), into=res)
    decode_row = profile_decode(eng, np.random.RandomState(5), cfg, path)
    readout = time_readout(eng.model, eng.params, cfg, path, decode_row)
    profile_prefill(eng, np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(8, 300)), path)
    eager = ServingEngine(cfg, params=eng.params, num_slots=8,
                          max_context=C, dtype=torch.bfloat16, seed=0,
                          decode_graph=False)
    prompts = forced_prompts(cfg.vocab_size)
    if is_ring(cfg):
        # positions 4093.. of a 4094-token prompt: its ring of the window
        # wraps at the fourth teacher-forced step
        prompts[-1] = list(np.random.RandomState(13).randint(
            0, cfg.vocab_size, size=cfg.sliding_window - 2))
    against_eager(path, eng, eager, cfg, reqs,
                  lambda: served_requests(cfg), expect, prompts)
    print(f"[{path} summary] {n_params / 1e9:.3f} B params, "
          f"{res['tokens_per_s']:.1f} tokens/s, decode step "
          f"{res['decode_step_ms']:.2f} ms, prefill call "
          f"{res['prefill_ms_mean']:.1f} ms, peak {res['peak_mem_gb']:.2f} "
          f"GB allocated, serve wall {res['wall_s']:.2f} s; readout "
          f"{readout['ms']:.3f} ms of {decode_row['kernel_ms']:.2f} "
          f"kernel ms a decode step; idle share {decode_row['idle']:.3f}")
    del eng, eager
    check_freed(path)
    return counts, readout


# ---------------------------------------------------------------------------
# ep: sharded serving, two expert ranks sharing the one card

#: the ep phase's layout: one data x ``EP_RANKS`` expert ranks, one process
#: each. NCCL refuses two ranks of one communicator on one card ("Duplicate
#: GPU detected", tools/probe_two_ranks_one_card.py), so the two processes
#: share the card over gloo, which stages every collective through host
#: memory: no wire is measured here
EP_RANKS = 2
EP_BACKEND = "gloo"
EP_DEVICE = "cuda"
EP_DTYPE = torch.bfloat16
#: the limit on the 2-rank engine's teacher-forced logits against the
#: one-rank engine's: the worst step's ||got - want|| / ||want|| over its
#: [8, V] logits. bf16: set from the sound readings (module docstring of
#: the ep phase); the off-by-one-expert control must fail it
EP_LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.3}
#: the f32 teacher-forced check of two ranks against one, both engines
#: cut alike to the depth where a near-tie first routed a token apart
#: (layer 10 of 12). All 24 layers fit (40.2 / 40.6 GB a rank) and read
#: 1.833e-6 with that tie routed as one rank (PERF.md), but took the
#: ep phase to 248 s and the whole run to 1047 s of its 1200 on a slow
#: host; 12 layers take about half the f32 part
EP_F32_LAYERS = 12
#: the ep serve's depth: qwen2-moe-a2.7b at full width cut from 24 layers
#: to 12 (24 until PR 27), for the run's time; the f32 check already runs
#: at this depth
EP_LAYERS = 12


def ep_config():
    return dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                               num_layers=EP_LAYERS)
#: a near-tie of the router: a token whose k-th and (k+1)-th router
#: probabilities in the one-rank f32 run lie closer than this may route
#: to other experts on two ranks by rounding alone (the two runs' router
#: GEMMs differ in shape and round ~1e-6 apart; one token of the 2 x 256
#: prefill call has its 4th and 5th 7.08e-8 apart in layer 10 and routed
#: apart, tools/probe_ep_engine_f32.py). ``TieRouting`` routes such a
#: token as the one-rank run did and prints its gap; a token routed apart
#: across a wider gap fails the check
EP_TIE_GAP = 1e-6
#: a re-balance threshold no load reaches: placement stays enabled (and
#: loads tracked) and nothing re-places but ``rebalance_now``
EP_NEVER = 1e9
#: seconds the parent waits for the ranks
EP_TIMEOUT_S = 900
#: the expert GEMM's widths timed at a rank's E = 30 in the kernel phase:
#: a decode step's (C = 1) and two of the ep serve's prefill widths (on
#: the measured H100 profile the serve gives C = 1, 2, 24, 50, 204, 408,
#: 614 and 818)
EP_GEMM_WIDTHS = {"decode": 1, "prefill": 408, "prefill C=818": 818}


def no_drop(cfg):
    """``cfg`` at the capacity factor E / top_k: every expert's capacity
    is the call's whole token count, so no assignment drops."""
    m = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k))


def forced_logits(eng, cfg, prompts, steps: int = 10) -> torch.Tensor:
    """``teacher_forced``'s protocol on one engine: admit ``prompts``
    (even ones greedy, odd ones at T=0.8), decode ``steps`` + 1 steps,
    every step after the first fed tokens drawn from a seed. Returns each
    step's logits, float32 [steps + 1, num_slots, V] on the CPU."""
    for i, p in enumerate(prompts):
        eng.submit(Request(prompt=list(p), max_new_tokens=steps + 4,
                           temperature=0.0 if i % 2 == 0 else 0.8))
    rng = np.random.RandomState(10)
    out = []
    for k in range(steps + 1):
        if k:
            eng.last_tokens.copy_(torch.from_numpy(rng.randint(
                0, cfg.vocab_size, size=(eng.num_slots, 1))))
        eng.step()
        out.append(eng.last_logits[:, -1].float().cpu())
    return torch.stack(out)


def logit_error(got, want) -> tuple:
    """(worst step's ||got - want|| / ||want||, max |got - want|, each
    step's relative error, the share of rows whose argmax agrees)."""
    d = (got - want).flatten(1)
    rel = d.norm(dim=1) / want.flatten(1).norm(dim=1)
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean()
    return (float(rel.max()), float(d.abs().max()),
            [round(float(x), 5) for x in rel], float(agree))


def ep_placement(E: int, E_loc: int) -> Placement:
    """A cross-rank placement of ``E`` experts on two ranks: experts 0
    and ``E_loc`` trade ranks (one moves each way), and each rank's last
    expert is replicated on both (two hot experts: the REP task's GEMM
    then has the two experts its controls swap)."""
    assignment = [e // E_loc for e in range(E)]
    assignment[0], assignment[E_loc] = 1, 0
    return Placement(E, 2, tuple(assignment),
                     replicated=(E_loc - 1, E - 1), epoch=1)


def shift_control(params, groups, E_loc: int, undo=None):
    """The off-by-one control's weights: expert rank 1's rows become
    experts [E_loc - 1, 2·E_loc - 1) (rank 0's last expert first, its own
    last one dropped), in place. Returns what ``undo`` takes to put them
    back (rank 1's dropped rows). Both ranks call it."""
    saved = {}
    for i, layer in enumerate(params["layers"]):
        for k, t in layer.get("moe", {}).get("experts", {}).items():
            if undo is not None:
                if groups.expert_rank == 1:
                    t[:-1] = t[1:].clone()
                    t[-1] = undo[(i, k)]
                continue
            row = t[-1].clone()
            torch.distributed.broadcast(row, src=groups.expert_peer(0),
                                        group=groups.expert)
            if groups.expert_rank == 1:
                saved[(i, k)] = t[-1].clone()
                t[1:] = t[:-1].clone()
                t[0] = row
    return saved


class Alltoalls:
    """While entered, records the bytes each rank sends in every
    ``all_to_all_single`` (the DEP walk's A2E and E2A)."""

    def __enter__(self):
        self.sizes = {}
        self._wrapped = torch.distributed.all_to_all_single

        def record(output, input, *args, **kw):
            n = input.numel() * input.element_size()
            self.sizes[n] = self.sizes.get(n, 0) + 1
            return self._wrapped(output, input, *args, **kw)
        torch.distributed.all_to_all_single = record
        return self

    def __exit__(self, *exc):
        torch.distributed.all_to_all_single = self._wrapped


def time_alltoall(sizes, groups, device) -> dict:
    """Host-clock ms of one ``all_to_all_single`` over the expert group at
    each byte size (a device sync before and after; median of 3 after a
    warm-up), every rank in the same order."""
    res = {}
    for n in sorted(sizes):
        send = torch.zeros(n // 2, dtype=torch.bfloat16, device=device)
        recv = torch.empty_like(send)
        samples = []
        for _ in range(4):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.distributed.all_to_all_single(recv, send,
                                                group=groups.expert)
            if device.type == "cuda":
                torch.cuda.synchronize()
            samples.append((time.perf_counter() - t0) * 1e3)
        res[n] = float(np.median(samples[1:]))
        del send, recv
    return res


def check_rows(eng, one_fps, rows, path: str, what: str) -> None:
    """Each local row ``j`` of every MoE layer's expert tensors holds the
    one-rank model's expert ``rows[j]`` (per-expert fingerprints)."""
    idx = torch.tensor(rows)
    for key, fp in expert_fingerprints(eng.params).items():
        if not torch.equal(fp.cpu(), one_fps[key][idx]):
            fail(f"{path}: layer {key[0]} {key[1]}: the rows are not the "
                 f"one-rank model's experts {rows[0]}..{rows[-1]} ({what})")


#: the ep serve's drift threshold (|EWMA residual|), and the decode step
#: after which rank 0 forces a re-calibration: early enough that its
#: local sweeps and its comm samples (one a step end) end within the
#: serve's 64 decode steps
EP_DRIFT_THRESHOLD = 0.5
EP_RECAL_STEP = 2


def fast_sweep_launches(res, device) -> dict:
    """Flash and decode launches of a calibration's local sweeps (the
    engine's fast sweeps, every retry included); none off the card, where
    the plain versions count no launch."""
    sweeps = sweeps_for(device, fast=True)
    calls = sum(sweep_counts(fast=True)) * (device.type == "cuda")
    return {"flash_attention": len(sweeps.attn) * calls
            * (1 + res.retries["attn"]),
            "decode_attention": len(sweeps.decode) * calls
            * (1 + res.retries["decode"])}


def describe_fit(res) -> dict:
    """Per primitive of a ``CalibrationResult``: alpha, beta, R^2,
    retries and the proxy flag."""
    return {k: dict(alpha=getattr(res.profile, k).alpha,
                    beta=getattr(res.profile, k).beta, r2=res.fit_r2[k],
                    retries=res.retries[k], proxy=res.samples[k].proxy)
            for k in res.fit_r2}


def print_fit(path: str, what: str, res) -> None:
    fits = describe_fit(res)
    print(f"[{path}] {what}: " + "; ".join(
        f"{k} alpha {f['alpha']:.4e} s, beta {f['beta']:.4e} s/unit, R^2 "
        f"{f['r2']:.6f}, retries {f['retries']}" for k, f in fits.items()),
        flush=True)
    comm = res.profile.comm
    print(f"[{path}] {what}: comm beta {comm.beta:.4e} s/B implies "
          f"{1e-9 / comm.beta:.3f} GB/s over host-staged gloo between two "
          "processes on one card (no wire); samples (bytes, median ms) "
          + json.dumps([[x, t * 1e3] for x, t in
                        zip(res.samples["comm"].xs, res.samples["comm"].ts)]),
          flush=True)


def ep_calibration(eng, device, path: str) -> dict:
    """The rank's calibration at construction (``calibrate=True``: the
    engine's fast sweeps and the comm sweep over the live expert group, on
    the main thread, nothing served yet): its own fit, the sweeps'
    launches against their calls, and its planner's profile (which
    ``phase_ep`` holds to rank 0's fit on every rank)."""
    res = eng.calibration
    counts = kernel_lib.launch_counts()
    want = fast_sweep_launches(res, device)
    for name, n in counts.items():
        if n != want.get(name, 0):
            fail(f"{path}: {name} launched {n} times in the calibration at "
                 f"construction, its sweeps call it {want.get(name, 0)} "
                 "times")
    if res.comm_is_proxy:
        fail(f"{path}: the comm fit is the copy proxy on a group of "
             f"{EP_RANKS} ranks")
    print_fit(path, f"calibrated at construction in {res.wall_s:.2f} s",
              res)
    return dict(fits=describe_fit(res), wall_s=res.wall_s,
                comm_gb_s=1e-9 / res.profile.comm.beta, launches=counts,
                own=res.profile.as_dict(),
                planner=eng.plan_policy.planner.hardware.as_dict())


class EpRecalibration:
    """The ep serve's re-calibration on one rank: rank 0 forces one after
    decode step ``EP_RECAL_STEP`` (``check``, a ``run_stepwise`` check);
    the rank's local sweeps are timed with the decode steps served
    meanwhile, each comm sample with the extra ms it adds to its step's
    end (the serve's all_to_all record ``a2a`` leaves the samples out),
    and each step's programs and host-clock end are kept, so that
    ``phase_ep`` can hold the ranks' programs equal step by step and the
    steps begun while the local sweeps ran are counted (the sweeps start
    at a step's end, so the next step begins during them unless the
    serving thread waits for them). It holds the engine's stats and
    recalibrator, not the engine."""

    def __init__(self, eng, rank: int, a2a):
        self.rank, self.stats, self.rc = rank, eng.stats, eng.recalibrator
        self.plan_stats, self.drift = eng.plan_cache.stats, eng.drift.stats
        self.a2a = a2a
        self.local, self.samples, self.steps, self.ends = [], [], [], []
        self.forced, self.ended_at = None, None
        self._local, self._sample = self.rc.local_fn, self.rc.sample_fn
        self.rc.local_fn, self.rc.sample_fn = self._timed_local, self._timed
        self.base = dict(recalibrations=self.rc.recalibrations,
                         joined=self.rc.joined)

    def _timed_local(self):
        s0, t0 = self.stats.steps, time.perf_counter()
        res = self._local()
        self.local = [s0, self.stats.steps, t0, time.perf_counter()]
        return res

    def _timed(self, size):
        keep = dict(self.a2a.sizes)
        t0 = time.perf_counter()
        try:
            return self._sample(size)
        finally:
            self.samples.append(dict(step=self.stats.steps, bytes=size,
                                     ms=(time.perf_counter() - t0) * 1e3))
            self.a2a.sizes.clear()
            self.a2a.sizes.update(keep)

    def check(self, before, after, programs) -> None:
        step = self.stats.steps
        self.steps.append([step, [describe(p) for _, p in programs]])
        self.ends.append(time.perf_counter())
        if self.ended_at is None and self.rc.joined > self.base["joined"]:
            self.ended_at = step
        if self.rank == 0 and step == EP_RECAL_STEP and self.forced is None:
            self.forced = self.rc.maybe_recalibrate(force=True)

    def expect(self, base, device):
        """``base``'s launches and the forced job's local sweeps'."""
        def want(st):
            w = base(st)
            if self.ended_at is None:
                fail(f"ep rank {self.rank}: the forced re-calibration did "
                     "not end within the serve")
            for k, n in fast_sweep_launches(self.rc.last_result,
                                            device).items():
                w[k] = w.get(k, 0) + n
            return w
        return want

    def report(self, path: str) -> dict:
        rc, res = self.rc, self.rc.last_result
        self.rc.refresher.drain()          # rank 0's fit lands
        role = dict(recalibrations=self.base["recalibrations"]
                    + (self.rank == 0), joined=self.base["joined"] + 1)
        got = dict(recalibrations=rc.recalibrations, joined=rc.joined)
        start, end, t0, t1 = self.local
        # (step, its begin and end on the host clock): a step begins when
        # the one before it has ended
        spans = [(step, a, b) for (step, _), a, b in
                 zip(self.steps[1:], self.ends, self.ends[1:])]
        begun = [step for step, a, _ in spans if t0 <= a < t1]
        steps = [s["step"] for s in self.samples]
        seen, new = set(), []
        for step, progs in self.steps:
            for p in progs:
                if p not in seen and step > self.ended_at:
                    new.append([step, p])
                seen.add(p)
        print_fit(path, f"re-calibrated mid-serve ({res.wall_s:.2f} s of "
                  "sweeps)", res)
        print(f"[{path}] the re-calibration: forced after decode step "
              f"{EP_RECAL_STEP} on rank 0; local sweeps {t1 - t0:.3f} s on "
              f"the refresh worker from the end of decode step {start}; "
              f"decode steps begun while they ran {begun}, ended while they "
              f"ran {end - start}; comm samples at step ends "
              + json.dumps([[s['step'], s['bytes'], round(s['ms'], 3)]
                            for s in self.samples])
              + f" (step, bytes, extra ms); the job ended at step "
              f"{self.ended_at}; {self.plan_stats.refreshes} re-solves, "
              f"{self.drift.drift_events} drift events; programs first "
              f"walked after it (step, program): {new}", flush=True)
        if got != role:
            fail(f"{path}: {got} after the forced re-calibration, the rank's "
                 f"role implies {role}")
        if self.rank == 0 and not self.forced:
            fail(f"{path}: the re-calibration was not forced")
        if not begun:
            fail(f"{path}: no decode step was served while the local sweeps "
                 f"ran ({t1 - t0:.3f} s)")
        if len(steps) != len(set(steps)):
            fail(f"{path}: a step end ran more than one comm sample {steps}")
        if len(steps) != len(rc.sizes) * (1 + res.retries["comm"]):
            fail(f"{path}: {len(steps)} comm samples, the sweep has "
                 f"{len(rc.sizes)} a try")
        return dict(local=[start, end, t1 - t0], begun=begun,
                    samples=self.samples,
                    fits=describe_fit(res), wall_s=res.wall_s,
                    ended_at=self.ended_at, steps=self.steps,
                    new_programs=new, refreshes=self.plan_stats.refreshes,
                    drift_events=self.drift.drift_events, **got)


def ep_rank_work(rank, groups, device, store_dir, profile) -> dict:
    """One rank of the ep phase (see ``phase_ep``)."""
    t0 = time.perf_counter()
    cfg = ep_config()
    E = cfg.moe.num_experts
    E_loc = E // EP_RANKS
    lo = rank * E_loc
    path = f"ep rank {rank}"
    one = torch.load(os.path.join(store_dir, "one_rank.pt"))
    if device.type == "cuda":
        # a gloo group cannot be captured: the default graph must raise,
        # before any weight is drawn
        refused = None
        try:
            ServingEngine(cfg, ep_group=groups, device=device, dtype=EP_DTYPE)
        except ValueError as e:
            refused = str(e)
        if refused is None or "decode_graph" not in refused:
            fail(f"{path}: the decode graph on a gloo group was not refused")
        print(f"[{path}] the decode graph on a gloo group of {EP_RANKS} "
              f"ranks is refused: {refused}", flush=True)
    kernel_lib.reset_launch_counts()
    eng = ServingEngine(cfg, num_slots=8, max_context=1024, dtype=EP_DTYPE,
                        device=device, seed=0,
                        plan_policy=dep_policy(cfg, profile),
                        calibrate=True,
                        profile_store=os.path.join(store_dir, "profiles"),
                        recalibrate_max_age_s=EP_NEVER,
                        drift_threshold=EP_DRIFT_THRESHOLD,
                        ep_group=groups, decode_graph=False,
                        rebalance_threshold=EP_NEVER)
    init_peak = (torch.cuda.max_memory_allocated() / 1e9
                 if device.type == "cuda" else 0.0)
    out = {"calibration": ep_calibration(eng, device, path)}
    n_params = sum(t.numel() for t in _leaves(eng.params))
    check_rows(eng, one["fingerprints"], list(range(lo, lo + E_loc)), path,
               "after init")
    print(f"[{path}] holds experts [{lo}, {lo + E_loc}) of {E} in every MoE "
          f"layer, each row the one-rank model's (fingerprints); "
          f"{n_params / 1e9:.3f} B params, peak {init_peak:.2f} GB "
          f"allocated while drawing them", flush=True)

    out["params_b"] = n_params / 1e9
    reqs = mixed_requests(cfg)
    res = {}
    with GemmWidths() as widths, Alltoalls() as a2a:
        recal = EpRecalibration(eng, rank, a2a)
        out["counts"] = serve(eng, reqs, cfg, path, recal.expect(
            dep_expect(cfg, expert_ranks=EP_RANKS), device),
                              step_check=recal.check, into=res)
    out["recal"] = recal.report(path)
    out["tokens"] = [r.output for r in reqs]
    out["serve"] = {k: res[k] for k in ("tokens_per_s", "decode_step_ms",
                                        "prefill_ms_mean", "decode_steps",
                                        "prefill_calls", "wall_s")}
    out["programs"] = sorted({describe(p) for _, p in eng.stats.programs})
    experts = eng.params["layers"][0]["moe"]["experts"]
    check_dep_widths({E_loc: experts}, widths.shapes, device, path)

    # teacher-forced against the one-rank engine, at no drop
    def forced(what):
        t = time.perf_counter()
        fe = ServingEngine(no_drop(cfg), params=eng.params, num_slots=8,
                           max_context=1024, dtype=EP_DTYPE, device=device,
                           seed=0, ep_group=groups, decode_graph=False,
                           track_expert_load=True)
        got = forced_logits(fe, cfg, forced_prompts(cfg.vocab_size))
        if fe.stats.dropped_tokens:
            fail(f"{path}: {fe.stats.dropped_tokens} assignments dropped in "
                 f"the {what} teacher-forced run")
        print(f"[{path}] the {what} teacher-forced run: "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        return logit_error(got, one["logits"])

    limit = EP_LOGIT_TOL[EP_DTYPE]
    out["forced"] = forced("sound")
    print(f"[{path}] teacher-forced against the one-rank engine, relative "
          f"error per step {out['forced'][2]}, argmax agreeing in "
          f"{out['forced'][3]:.1%} of the rows", flush=True)
    if out["forced"][0] > limit:
        fail(f"{path}: teacher-forced logits {out['forced'][0]:.3e} off the "
             f"one-rank engine's (relative), over the limit {limit}")
    saved = shift_control(eng.params, groups, E_loc)
    out["control"] = forced("control")
    shift_control(eng.params, groups, E_loc, undo=saved)
    check_rows(eng, one["fingerprints"], list(range(lo, lo + E_loc)), path,
               "after the control was undone")
    print(f"[{path}] the control, relative error per step "
          f"{out['control'][2]}, argmax agreeing in "
          f"{out['control'][3]:.1%} of the rows", flush=True)
    if out["control"][0] <= limit:
        fail(f"{path}: the off-by-one-expert control reads "
             f"{out['control'][0]:.3e}, within the limit {limit}")
    print(f"[{path}] 11 teacher-forced steps (capacity factor "
          f"{no_drop(cfg).moe.capacity_factor}, nothing dropped) against "
          f"the one-rank engine: worst step {out['forced'][0]:.3e} relative "
          f"(max |d| {out['forced'][1]:.3e}), limit {limit}; the control "
          f"(rank 1 holding experts [{E_loc - 1}, {E - 1})) reads "
          f"{out['control'][0]:.3e} (max |d| {out['control'][1]:.3e})",
          flush=True)

    # a cross-rank re-placement, in place
    pl = ep_placement(E, E_loc)
    layers = eng.params["layers"]
    ptrs = {(i, k): t.data_ptr() for i, layer in enumerate(layers)
            if "moe" in layer for k, t in layer["moe"]["experts"].items()}
    if eng.rebalance_now(pl) != pl:
        fail(f"{path}: rebalance_now installed {eng.placement}, not {pl}")
    for (i, k), ptr in ptrs.items():
        if layers[i]["moe"]["experts"][k].data_ptr() != ptr:
            fail(f"{path}: layer {i} {k} moved in the re-placement")
    inv = [int(e) for e in np.argsort(pl.perm)]
    check_rows(eng, one["fingerprints"], inv[lo:lo + E_loc], path,
               "after the re-placement")
    hot = eng._device_placement.hot_weights
    rep = list(pl.replicated)
    for i, layer in enumerate(layers):
        for k in layer.get("moe", {}).get("experts", {}):
            fp = hot[i][k].view(torch.int16).sum(dim=(1, 2),
                                                 dtype=torch.int64)
            if not torch.equal(fp.cpu(), one["fingerprints"][(i, k)][rep]):
                fail(f"{path}: layer {i} {k}: the hot weights are not "
                     f"experts {rep}'")
    print(f"[{path}] re-placed in place: experts 0 and {E_loc} traded ranks, "
          f"experts {rep} replicated, each from its owner; {len(ptrs)} "
          f"expert tensors at their addresses hold experts "
          f"{inv[lo:lo + E_loc]} and the hot weights experts {rep}' "
          "(fingerprints)", flush=True)
    reqs = mixed_requests(cfg, seed=1)[:8]
    res = {}
    with GemmWidths() as placed:
        serve(eng, reqs, cfg, f"{path} placed",
              dep_expect(cfg, since=eng.stats, expert_ranks=EP_RANKS),
              into=res)
    out["placed_tokens"] = [r.output for r in reqs]
    check_dep_widths({E_loc: experts, len(rep): hot[0]}, placed.shapes, device,
                     f"{path} placed")
    t = time.perf_counter()
    gloo_ms = time_alltoall(a2a.sizes, groups, device)
    print(f"[{path}] timed {len(gloo_ms)} all_to_all sizes in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    out["alltoall"] = {n: (c, gloo_ms[n]) for n, c in a2a.sizes.items()}
    out["peak_gb"] = max(init_peak, torch.cuda.max_memory_allocated() / 1e9
                         if device.type == "cuda" else 0.0)
    eng.close()
    del eng, experts, hot, layers
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ep_rank_f32(rank, groups, device, one["f32"], out)
    out["wall_s"] = time.perf_counter() - t0
    return out


def ep_rank_f32(rank, groups, device, want, out) -> None:
    """The rank's f32 check: an engine at ``EP_F32_LAYERS`` (capacity
    factor E / top_k, f32 weights drawn from seed 0, its E / 2 experts)
    on the two ranks, 11 teacher-forced steps routing every token as the
    one-rank f32 engine does (``TieRouting``: a near-tie routed apart is
    routed as one rank did, any other reroute fails) and within
    ``EP_LOGIT_TOL[torch.float32]`` of its logits (``want``, from
    ``ep_f32_reference``), and the off-by-one-expert control beyond
    it."""
    path = f"ep rank {rank} f32"
    t = time.perf_counter()
    cfg = dataclasses.replace(no_drop(get_config("qwen2-moe-a2.7b")),
                              num_layers=EP_F32_LAYERS)
    E_loc = cfg.moe.num_experts // EP_RANKS
    eng = ServingEngine(cfg, num_slots=8, max_context=1024,
                        dtype=torch.float32, device=device, seed=0,
                        ep_group=groups, decode_graph=False,
                        track_expert_load=True)
    limit = EP_LOGIT_TOL[torch.float32]
    with TieRouting(want, rank, EP_RANKS, cfg.num_layers,
                    EP_TIE_GAP) as rec:
        got = forced_logits(eng, cfg, forced_prompts(cfg.vocab_size))
    out["forced_f32"] = logit_error(got, want["logits"])
    out["ties_f32"], out["rerouted_f32"] = rec.ties, rec.apart
    if eng.stats.dropped_tokens:
        fail(f"{path}: {eng.stats.dropped_tokens} assignments dropped")
    if rec.apart:
        fail(f"{path}: tokens routed apart from the one-rank run's routing "
             f"across a gap of at least {EP_TIE_GAP} (call, layer, tokens, "
             f"smallest gap) {rec.apart}")
    if rec.calls != len(want["experts"]):
        fail(f"{path}: {rec.calls} routings against the one-rank run's "
             f"{len(want['experts'])}")
    params = eng.params
    del eng
    if device.type == "cuda":
        torch.cuda.empty_cache()
    fe = ServingEngine(cfg, params=params, num_slots=8, max_context=1024,
                       dtype=torch.float32, device=device, seed=0,
                       ep_group=groups, decode_graph=False)
    shift_control(params, groups, E_loc)
    out["control_f32"] = logit_error(forced_logits(
        fe, cfg, forced_prompts(cfg.vocab_size)), want["logits"])
    if device.type == "cuda":
        out["peak_f32_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
    print(f"[{path}] {EP_F32_LAYERS} layers, 11 teacher-forced steps "
          f"routing every token as one rank does ({rec.calls} routings; "
          f"near-ties under {EP_TIE_GAP} routed apart by rounding and "
          f"routed as one rank, (call, layer, token, gap): {rec.ties}), "
          f"against the one-rank f32 engine: worst step "
          f"{out['forced_f32'][0]:.3e} (max |d| {out['forced_f32'][1]:.3e}; "
          f"per step {out['forced_f32'][2]}), limit {limit}; the "
          f"off-by-one-expert control {out['control_f32'][0]:.3e}; peak "
          f"{out.get('peak_f32_gb', 0):.2f} GB; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if out["forced_f32"][0] > limit:
        fail(f"{path}: teacher-forced logits {out['forced_f32'][0]:.3e} off "
             f"the one-rank engine's, over the limit {limit}")
    if out["control_f32"][0] <= limit:
        fail(f"{path}: the control reads {out['control_f32'][0]:.3e}, "
             f"within the limit {limit}")
    del fe, params


def ep_rank(rank: int, store_dir: str, profile, results, setup=None):
    """A spawned rank process of the ep phase: joins the gloo group over
    the ``file://`` store in ``store_dir`` and runs ``ep_rank_work``;
    puts (rank, its results) on ``results``. ``setup`` (the CPU
    rehearsal's) runs first."""
    if setup is not None:
        setup()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(EP_DEVICE, 0) if EP_DEVICE == "cuda" \
        else torch.device(EP_DEVICE)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    groups = DepGroups.from_file_store(os.path.join(store_dir, "store"),
                                       rank, 1, EP_RANKS, EP_BACKEND)
    try:
        results.put((rank, ep_rank_work(rank, groups, device, store_dir,
                                        profile)))
    finally:
        torch.distributed.destroy_process_group()


class MoeRecord:
    """While entered, keeps each MoE layer's input shape and each
    routing's probabilities and expert ids (on the CPU), in call order."""

    def __enter__(self):
        self.shapes, self.probs, self.experts = [], [], []
        self._apply = transformer_lib._apply_moe
        self._route = moe_lib.route_topk

        def apply(p, cfg, h, *a, **kw):
            self.shapes.append(tuple(h.shape))
            return self._apply(p, cfg, h, *a, **kw)

        def route(*a, **kw):
            r = self._route(*a, **kw)
            self.probs.append(r.probs.detach().float().cpu())
            self.experts.append(r.experts.detach().cpu())
            return r
        transformer_lib._apply_moe, moe_lib.route_topk = apply, route
        return self

    def __exit__(self, *exc):
        transformer_lib._apply_moe = self._apply
        moe_lib.route_topk = self._route


class TieRouting:
    """While entered, a rank of an expert group routes as the one-rank
    f32 run ``want`` did (``ep_f32_reference``: each routing's input
    shape, experts and gap between its k-th and (k+1)-th probabilities,
    in call order) wherever the two differ by rounding: a token whose set
    of top-k experts differs from ``want``'s takes ``want``'s experts
    (weighted by the rank's own probabilities, renormalised as
    ``route_topk`` does) if ``want``'s gap there is under ``tie``, and is
    listed in ``ties`` as (call, layer, token, gap). Any other token
    routed apart is counted in ``apart`` as (call, layer, tokens,
    smallest gap). In sequence mode the rank routes its part of each
    row's sequence, otherwise every token."""

    def __init__(self, want, rank: int, ranks: int, layers: int,
                 tie: float):
        self.want, self.rank, self.ranks = want, rank, ranks
        self.layers, self.tie = layers, tie
        self.calls, self.ties, self.apart = 0, [], []

    def __enter__(self):
        self._route = moe_lib.route_topk

        def route(router_params, x_flat, mcfg, num_experts_padded=0):
            r = self._route(router_params, x_flat, mcfg, num_experts_padded)
            return self._force(r)
        moe_lib.route_topk = route
        return self

    def __exit__(self, *exc):
        moe_lib.route_topk = self._route

    def _force(self, r):
        i = self.calls
        self.calls += 1
        if i >= len(self.want["experts"]):
            fail(f"routing: more than the one-rank run's "
                 f"{len(self.want['experts'])} routings")
        B, S, _ = self.want["shapes"][i]
        e = r.experts
        N, k = e.shape
        w = self.want["experts"][i].view(B, S, k)
        g = self.want["gaps"][i].view(B, S)
        if N < B * S:                         # sequence mode
            part = S // self.ranks
            cut = slice(self.rank * part, (self.rank + 1) * part)
            w, g = w[:, cut], g[:, cut]
        w, g = w.reshape(N, k), g.reshape(N)
        diff = (e.cpu().sort(-1).values != w.sort(-1).values).any(-1)
        if not diff.any():
            return r
        at = diff.nonzero()[:, 0]
        near = g[at] < self.tie
        call, layer = divmod(i, self.layers)
        self.ties += [(call, layer, int(t), float(g[t])) for t in at[near]]
        if (~near).any():
            self.apart.append((call, layer, int((~near).sum()),
                               float(g[at[~near]].min())))
        if not near.any():
            return r
        experts = e.clone()
        tok = at[near].to(e.device)
        experts[tok] = w[at[near]].to(e.device, e.dtype)
        weights = r.probs.gather(-1, experts)
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
        return moe_lib.Routing(weights=weights.to(r.weights.dtype),
                               experts=experts, probs=r.probs)


def ep_dep_baseline(one, cfg, profile, want) -> tuple:
    """One rank's bf16 baseline between two sound routes on the same
    weights: the DEP walk on a gloo group of one rank (the FinDEP plans
    on the measured profile, eager) against the one-rank capacity engine
    ``one``'s teacher-forced logits ``want``, both at no drop."""
    groups = DepGroups.single("gloo")
    try:
        eng = ServingEngine(no_drop(cfg), params=one.params, num_slots=8,
                            max_context=1024, dtype=EP_DTYPE,
                            device=EP_DEVICE, seed=0,
                            plan_policy=dep_policy(cfg, profile),
                            profile=profile, ep_group=groups,
                            decode_graph=False, track_expert_load=True)
        got = forced_logits(eng, cfg, forced_prompts(cfg.vocab_size))
        if eng.stats.dropped_tokens:
            fail(f"ep: the DEP baseline dropped {eng.stats.dropped_tokens}")
        err = logit_error(got, want)
        del eng
    finally:
        torch.distributed.destroy_process_group()
    print(f"[ep] one rank, {str(EP_DTYPE)[6:]}, {cfg.num_layers} layers: "
          f"the DEP walk against the "
          f"capacity path on the same weights, teacher-forced: worst step "
          f"{err[0]:.3e} (per step {err[2]})", flush=True)
    return err


def ep_f32_reference(cfg) -> tuple:
    """The one-rank engine at ``EP_F32_LAYERS`` in f32 (every expert,
    capacity path, no drop, weights from seed 0): its teacher-forced
    logits, routings and each routed token's gap between its k-th and
    (k+1)-th probabilities, which the ranks' f32 check is held to; and
    the same engine in bf16 against them (what bf16 rounding alone gives
    at that depth)."""
    t = time.perf_counter()
    cut = dataclasses.replace(no_drop(cfg), num_layers=EP_F32_LAYERS)
    logits = {}
    for dt in (torch.float32, torch.bfloat16):
        eng = ServingEngine(cut, num_slots=8, max_context=1024, dtype=dt,
                            device=EP_DEVICE, seed=0, decode_graph=False,
                            track_expert_load=True)
        with MoeRecord() as rec:
            logits[dt] = forced_logits(eng, cut,
                                       forced_prompts(cfg.vocab_size))
        if dt == torch.float32:
            k = cut.moe.top_k
            routing = dict(shapes=rec.shapes, experts=rec.experts,
                           gaps=[(lambda v: v[:, k - 1] - v[:, k])(
                               p.topk(k + 1, dim=-1).values)
                               for p in rec.probs])
        del rec
        if eng.stats.dropped_tokens:
            fail(f"ep: the one-rank {dt} engine dropped assignments")
        del eng
        if EP_DEVICE == "cuda":
            torch.cuda.empty_cache()
    err = logit_error(logits[torch.bfloat16], logits[torch.float32])
    print(f"[ep] the one-rank engine at {EP_F32_LAYERS} layers: f32 logits "
          f"and routings for the ranks' f32 check; bf16 against f32 worst "
          f"step {err[0]:.3e} (per step {err[2]}); "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    return dict(logits=logits[torch.float32], **routing), err


def phase_ep(profile, setup=None) -> dict:
    """Sharded serving on one card: qwen2-moe-a2.7b at full width cut to
    ``EP_LAYERS`` (60 experts, bf16, seed 0) on an expert group of two
    ranks, two spawned
    processes sharing the card over gloo, each holding 30 experts. First
    the one-rank engine (every expert, capacity path, eager, capacity
    factor E / top_k) takes 11 teacher-forced decode steps over
    ``FORCED_LENGTHS`` and gives its per-expert fingerprints; it is freed
    before the ranks start. Each rank: its rows are the one-rank model's
    [r·30, (r+1)·30); the decode graph over gloo is refused; the engine
    calibrates at construction (``calibrate=True``: every rank's fast
    sweeps and the comm sweep over the expert group; every rank plans
    from rank 0's fit, the sweeps launch flash and decode as often as
    they call them); the 16 ``mixed_requests`` (8 slots, max_context
    1024, eager, FinDEP, drift at ``EP_DRIFT_THRESHOLD``) all finish
    while a re-calibration forced on rank 0 after decode step
    ``EP_RECAL_STEP`` runs (``EpRecalibration``: at least one step served
    during the local sweeps, one comm sample a step end, the same step
    ends and the same programs on both ranks, ``recalibrations`` 1 on rank
    0 and 0 on rank 1), the expert GEMM launching L x Σ r1·r2
    (``dep_expect``, read on each rank; flash and decode also the local
    sweeps' calls); the expert GEMM
    against its plain version at every (E = 30, C) of the serve;
    11 teacher-forced steps at no drop within ``EP_LOGIT_TOL`` of the
    one-rank engine's, and a control with rank 1's shard off by one
    expert beyond it; ``rebalance_now`` with a placement that moves an
    expert each way and replicates one, in place, then 8 more requests.
    Both ranks must hold the same tokens. Prints per rank tokens/s,
    eager decode-step and prefill-call ms, the A2E/E2A bytes and gloo's
    ms for them, and peak GB. ``setup`` runs first in each rank (the CPU
    rehearsal's patches). Returns rank 0's serve launch counts."""
    import multiprocessing
    import queue
    t0 = time.perf_counter()
    cfg = ep_config()
    one = ServingEngine(no_drop(cfg), num_slots=8, max_context=1024,
                        dtype=EP_DTYPE, device=EP_DEVICE, seed=0,
                        decode_graph=False, track_expert_load=True)
    shared = {"fingerprints": {k: v.cpu() for k, v in
                               expert_fingerprints(one.params).items()},
              "logits": forced_logits(one, cfg,
                                      forced_prompts(cfg.vocab_size))}
    if one.stats.dropped_tokens:
        fail(f"ep: the one-rank engine dropped {one.stats.dropped_tokens} "
             "assignments")
    baselines = {"dep_vs_capacity": ep_dep_baseline(one, cfg, profile,
                                                    shared["logits"])}
    del one
    if EP_DEVICE == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    print(f"[ep] the one-rank engine (every expert, capacity factor "
          f"{no_drop(cfg).moe.capacity_factor}, nothing dropped): 11 "
          f"teacher-forced steps in {time.perf_counter() - t0:.1f} s; freed",
          flush=True)
    shared["f32"], baselines["bf16_vs_f32"] = ep_f32_reference(cfg)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ep-") as store_dir:
        torch.save(shared, os.path.join(store_dir, "one_rank.pt"))
        procs = [ctx.Process(target=ep_rank, args=(r, store_dir, profile,
                                                   results, setup))
                 for r in range(EP_RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + EP_TIMEOUT_S
        while len(got) < EP_RANKS:
            try:
                r, res = results.get(timeout=5)
                got[r] = res
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead or time.monotonic() > deadline:
                    for p in procs:
                        p.kill()
                        p.join()
                    fail(f"ep: a rank failed or timed out (exit codes "
                         f"{[p.exitcode for p in procs]})")
        for p in procs:
            p.join(timeout=120)
            if p.exitcode != 0:
                fail(f"ep: a rank exited with {p.exitcode}")
    for what in ("tokens", "placed_tokens"):
        if any(got[r][what] != got[0][what] for r in range(EP_RANKS)):
            fail(f"ep: the ranks' {what} differ")
    lead = got[0]["calibration"]["own"]
    for r in range(EP_RANKS):
        if got[r]["calibration"]["planner"] != lead:
            fail(f"ep: rank {r} plans from {got[r]['calibration']['planner']}"
                 f", not rank 0's fit {lead}")
        if got[r]["recal"]["steps"] != got[0]["recal"]["steps"]:
            fail(f"ep: rank {r}'s programs differ from rank 0's at some "
                 "decode step")
        if ([s["step"] for s in got[r]["recal"]["samples"]]
                != [s["step"] for s in got[0]["recal"]["samples"]]):
            fail(f"ep: rank {r} ran its comm samples at other step ends")
    print(f"[ep] every rank plans from rank 0's fit at construction; the "
          f"re-calibration's comm samples ran at the same step ends on both "
          f"ranks, and both walked the same programs at every decode step; "
          f"programs first walked after the re-calibration (step, program) "
          f"{got[0]['recal']['new_programs']}")
    f32 = got[0]["forced_f32"]
    print(f"[ep] the bf16 gap, settled at f32: two ranks against one at "
          f"{EP_F32_LAYERS} layers, f32: worst step {f32[0]:.3e} (limit "
          f"{EP_LOGIT_TOL[torch.float32]}; control "
          f"{got[0]['control_f32'][0]:.3e}; near-ties routed as one rank "
          f"(rank: (call, layer, token, gap)) "
          f"{ {r: got[r]['ties_f32'] for r in got} }); "
          f"{str(EP_DTYPE)[6:]} at "
          f"{cfg.num_layers} layers: two ranks "
          f"against one {got[0]['forced'][0]:.3e}, one rank's DEP walk "
          f"against its capacity path {baselines['dep_vs_capacity'][0]:.3e}"
          f"; one rank bf16 against f32 at {EP_F32_LAYERS} layers "
          f"{baselines['bf16_vs_f32'][0]:.3e}; " + json.dumps(baselines))
    print(f"[ep] both ranks hold the same tokens for all 16 requests and "
          f"the 8 after the re-placement; programs walked "
          f"{got[0]['programs']}")
    for r in range(EP_RANKS):
        g = got[r]
        s = g["serve"]
        a2a = {f"{n / 1e6:.2f} MB x{c}": round(ms, 3)
               for n, (c, ms) in g["alltoall"].items()}
        print(f"[ep rank {r}] {g['params_b']:.3f} B params; serve "
              f"{s['tokens_per_s']:.1f} tokens/s, {s['decode_steps']} eager "
              f"decode steps at {s['decode_step_ms']:.2f} ms, "
              f"{s['prefill_calls']} prefill calls at "
              f"{s['prefill_ms_mean']:.1f} ms; A2E/E2A bytes a rank sends "
              f"per all_to_all (x calls in the serve): gloo ms for one "
              f"{a2a}; peak {g['peak_gb']:.2f} GB allocated; rank wall "
              f"{g['wall_s']:.1f} s; teacher-forced {g['forced'][0]:.3e}, "
              f"control {g['control'][0]:.3e}")
    print(f"[ep] transport: host-staged gloo between two processes on one "
          f"card; no wire is measured, and no overlap claim is made; phase "
          f"wall {time.perf_counter() - t0:.1f} s")
    print("[ep] " + json.dumps({str(r): {k: v for k, v in got[r].items()
                                         if k not in ("tokens",
                                                      "placed_tokens",
                                                      "alltoall", "recal")}
                                for r in got}))
    print("[ep] re-calibration " + json.dumps(
        {str(r): {k: v for k, v in got[r]["recal"].items() if k != "steps"}
         for r in got}))
    return got[0]["counts"]


#: the xLSTM path's depth: xlstm-1.3b at full width cut from 48 layers to
#: one 7:1 pattern, 8 (7 mLSTM + 1 sLSTM; 24 from PR 26, 48 before), which
#: keeps every layer kind and kernel shape of the full model and makes room
#: for the recurrent train path (its sLSTM prefill loop was most of the
#: phase)
XLSTM_LAYERS = 8


def phase_serve_xlstm():
    """The xLSTM path: xlstm-1.3b at full width and ``XLSTM_LAYERS``,
    every mLSTM layer through the mLSTM scan kernel at prefill and
    decode, with the decode graph; held against an eager engine on the
    same weights and timed beside it."""
    cfg = dataclasses.replace(get_config("xlstm-1.3b"),
                              num_layers=XLSTM_LAYERS)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, num_slots=8, max_context=1024,
                        dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    kinds = eng.model.kinds
    n_m = kinds.count("mlstm")
    print(f"[xlstm] {cfg.name}: {cfg.num_layers} layers ({n_m} mLSTM + "
          f"{kinds.count('slstm')} sLSTM), d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads, vocab {cfg.vocab_size}; "
          f"{n_params / 1e9:.3f} B params drawn in bf16 on the card in "
          f"{time.perf_counter() - t0:.1f} s (ModelConfig.num_params() "
          f"says {cfg.num_params() / 1e9:.3f} B)")
    reqs = mixed_requests(cfg)

    def expect(st):
        return {"mlstm_scan": n_m * (st.steps + st.prefill_calls)}

    counts = serve(eng, reqs, cfg, "xlstm", expect)
    print(f"[xlstm] (mlstm_scan {n_m} per decode step and per prefill "
          "call)")
    profile_decode(eng, np.random.RandomState(5), cfg, "xlstm")
    profile_prefill(eng, np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(1, 600)), "xlstm")
    eager = ServingEngine(cfg, params=eng.params, num_slots=8,
                          max_context=1024, dtype=torch.bfloat16, seed=0,
                          decode_graph=False)
    against_eager("xlstm", eng, eager, cfg, reqs,
                  lambda: mixed_requests(cfg), expect,
                  forced_prompts(cfg.vocab_size))
    profile_decode(eager, np.random.RandomState(5), cfg, "xlstm eager")
    compare_decode({"graph": eng, "eager": eager}, cfg)
    del eng, eager
    torch.cuda.empty_cache()
    return counts


def hybrid_requests(cfg):
    """The first 14 of ``mixed_requests`` and two long prompts: 2040
    tokens (greedy), whose 2048-slot ring wraps during its decode, and
    3000 tokens (T=0.8), whose prefill rolls the ring."""
    rng = np.random.RandomState(6)
    long = [Request(prompt=list(rng.randint(0, cfg.vocab_size, size=n)),
                    max_new_tokens=32, temperature=t)
            for n, t in ((2040, 0.0), (3000, 0.8))]
    return mixed_requests(cfg)[:14] + long


def phase_serve_hybrid():
    """The hybrid path: full recurrentgemma-9b, every RG-LRU layer through
    the RG-LRU scan kernel at prefill and decode, every local-attention
    layer through the flash kernel at prefill and the plain ring SDPA at
    decode, with the decode graph; held against an eager engine on the
    same weights (the teacher-forced prompts include one whose ring wraps
    during the steps) and timed beside it."""
    cfg = get_config("recurrentgemma-9b")
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, num_slots=8, max_context=4096,
                        dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    kinds = eng.model.kinds
    n_rec, n_attn = kinds.count("rec"), kinds.count("attn")
    print(f"[hybrid] {cfg.name}: {cfg.num_layers} layers ({n_rec} RG-LRU + "
          f"{n_attn} local attention, window {cfg.sliding_window}), d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, lru_width {cfg.recurrent.lru_width}, vocab "
          f"{cfg.vocab_size}; {n_params / 1e9:.3f} B params drawn in bf16 on "
          f"the card in {time.perf_counter() - t0:.1f} s "
          f"(ModelConfig.num_params() says {cfg.num_params() / 1e9:.3f} B)")
    reqs = hybrid_requests(cfg)

    def expect(st):
        return {"rg_lru_scan": n_rec * (st.steps + st.prefill_calls),
                "flash_attention": n_attn * st.prefill_calls}

    counts = serve(eng, reqs, cfg, "hybrid", expect)
    print(f"[hybrid] (rg_lru_scan {n_rec} per decode step and per prefill "
          f"call, flash_attention {n_attn} per prefill call)")
    profile_decode(eng, np.random.RandomState(5), cfg, "hybrid")
    profile_prefill(eng, np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(1, 3000)), "hybrid")
    eager = ServingEngine(cfg, params=eng.params, num_slots=8,
                          max_context=4096, dtype=torch.bfloat16, seed=0,
                          decode_graph=False)
    prompts = forced_prompts(cfg.vocab_size)
    # positions 2043.. of a 2044-token prompt: its 2048-slot ring wraps at
    # the sixth teacher-forced step
    prompts[-1] = list(np.random.RandomState(13).randint(
        0, cfg.vocab_size, size=2044))
    against_eager("hybrid", eng, eager, cfg, reqs,
                  lambda: hybrid_requests(cfg), expect, prompts)
    profile_decode(eager, np.random.RandomState(5), cfg, "hybrid eager")
    compare_decode({"graph": eng, "eager": eager}, cfg)
    del eng, eager
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# multimodal: the vlm and audio families at full width and depth

#: where and at what dtype the multimodal phase runs (the CPU rehearsal
#: takes the CPU at f32)
MM_DEVICE = "cuda"
MM_DTYPE = torch.bfloat16
#: rows, prompt tokens, greedy serve steps, teacher-forced steps
MM_BATCH, MM_PROMPT, MM_STEPS, MM_FORCED = 8, 64, 32, 11
#: the teacher-forced check's limit on the worst step's relative L2 of
#: the decode logits against ``forward``'s over the same sequence. f32:
#: summation order. bf16: the sound readings were 0.0279 (internvl2) and
#: 0.0148 (seamless) and the controls 0.596-0.873 on the H100 (PERF.md), so
#: 0.05 is 1.8x the worst sound step and 12x under the least control
MM_LOGIT_TOL = {torch.float32: 1e-4, torch.bfloat16: 0.05}


def expect_launches(what: str, got: dict, want: dict) -> None:
    """Every kernel's launches exactly ``want`` (absent = 0)."""
    full = {name: want.get(name, 0) for name in got}
    if got != full:
        fail(f"{what}: launches {got}, want {full}")


def launch_delta(before: dict) -> dict:
    return {k: v - before[k] for k, v in kernel_lib.launch_counts().items()}


def mm_forced(model, params, toks, extra, memory, label: str,
              control) -> dict:
    """11 teacher-forced decode steps against ``forward`` over the same
    sequence: prefill the first ``MM_PROMPT`` tokens (vlm: behind the
    patch embeddings), feed the next ``MM_FORCED`` one a step (audio: the
    memory's cross-attention at every step) and hold each step's logits
    against ``forward``'s at its position (relative L2 per step, at most
    ``MM_LOGIT_TOL``). The control ({"extra": ...} or {"memory": ...}
    for the decode steps) must exceed the limit at every step."""
    cfg = model.cfg
    vlm = cfg.family == "vlm"
    S = MM_PROMPT + MM_FORCED
    off = extra.shape[1] if vlm else 0
    with torch.no_grad():
        full, _ = model.forward(params, toks[:, :S],
                                extra_embeds=extra if vlm else None,
                                memory=memory)
        want = full[:, off + MM_PROMPT:off + S].transpose(0, 1).float().cpu()
        del full

        def run(ext, mem):
            _, caches = model.prefill(params, toks[:, :MM_PROMPT],
                                      extra_embeds=ext if vlm else None,
                                      memory=memory, seq_budget=S)
            got = []
            for t in range(MM_PROMPT, S):
                lg, caches = model.decode_step(params, toks[:, t:t + 1],
                                               caches, memory=mem)
                got.append(lg[:, 0].float().cpu())
            return torch.stack(got)

        sound = logit_error(run(extra, memory), want)
        wrong = logit_error(run(control.get("extra", extra),
                                control.get("memory", memory)), want)
    limit = MM_LOGIT_TOL[model.dtype]
    print(f"[{label}] teacher-forced: {MM_FORCED} decode steps against "
          f"forward, relative L2 worst {sound[0]:.4g} (steps {sound[2]}), "
          f"max |dlogit| {sound[1]:.4g}, argmax agreeing in "
          f"{sound[3]:.1%}; limit {limit}; control ({control['label']}) "
          f"least step {min(wrong[2]):.4g} (steps {wrong[2]}), argmax "
          f"agreeing in {wrong[3]:.1%}")
    if not sound[0] <= limit:
        fail(f"{label}: decode logits {sound[0]:.4g} off forward's, over "
             f"the limit {limit}")
    if not min(wrong[2]) > limit:
        fail(f"{label}: the control ({control['label']}) is within the "
             f"limit {limit} at a step: the check cannot see that fault")
    return dict(forced_rel_l2=sound[0], forced_steps=sound[2],
                forced_argmax_agree=sound[3], control_rel_l2=wrong[2])


def step_device_ms(step) -> float:
    """Device ms of every kernel one eager serve step runs (the profiler:
    ``device_ms`` with no kernel filter, three steps a trace after a lead
    step, two traces that agree on a multiple of three events). The step
    writes the same cache row each time, so it can run again."""
    return device_ms(step, iters=3, lead=True)


def time_cross_kv(params, memory) -> float:
    """Device ms (CUDA events) of what every decode step recomputes for
    cross-attention, as the reference does: each decoder layer's K and V
    projections of the whole memory."""
    layers = [p["cross"] for p in params["layers"]]

    def run():
        for c in layers:
            dense_apply(c["wk"], memory)
            dense_apply(c["wv"], memory)

    return time_ms(run, iters=5)


def serve_multimodal(arch: str, label: str) -> dict:
    """One family at full width and depth through the port's step
    builders: bf16 weights from seed 0, ``MM_BATCH`` rows of the stub
    frontend's embeddings (seed 1) and a ``MM_PROMPT``-token prompt; the
    audio model encodes (timed alone), ``make_prefill_step`` prefills
    (audio: encoding again), then ``MM_STEPS`` greedy
    ``make_serve_step``s. Launches checked exactly, from the wrappers'
    counts around each call: flash L_enc in the encode (the encoder's
    bidirectional layers), L + L_enc a prefill (the decoder's L causal
    ones beside them), dense decode L a step (+ L cross-attention calls
    over the memory), nothing else. Then the teacher-forced check.
    Returns the launch counts of the prefill and the serve."""
    cfg = get_config(arch)
    L, L_enc = cfg.num_layers, cfg.num_encoder_layers
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, ctx=ExecutionContext(attn_impl="decode_kernel"),
                        dtype=MM_DTYPE, device=MM_DEVICE)
    params = model.init(generator_for(model.device, 0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[{label}] {cfg.name} ({cfg.family}): {L} decoder layers"
          f"{f' + {L_enc} encoder layers' if L_enc else ''}, d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, vocab {cfg.vocab_size}, {cfg.frontend_tokens} "
          f"{'frames' if L_enc else 'patch embeddings'} a row; "
          f"{n_params / 1e9:.3f} B params drawn in {MM_DTYPE} on the card "
          f"in {time.perf_counter() - t0:.1f} s (ModelConfig.num_params() "
          f"says {cfg.num_params() / 1e9:.3f} B)")
    extra = frontend_inputs(cfg, MM_BATCH, MM_PROMPT,
                            generator_for(model.device, 1),
                            device=model.device, dtype=MM_DTYPE)
    toks = torch.from_numpy(np.random.RandomState(11).randint(
        0, cfg.vocab_size, size=(MM_BATCH, MM_PROMPT + MM_FORCED))).to(
            model.device)
    prompt = toks[:, :MM_PROMPT]
    prefill_step, serve_step = make_prefill_step(model), \
        make_serve_step(model)
    out = {}
    with torch.no_grad():
        # warm-up: the first calls pay cuBLAS's and the allocator's set-up
        logits, caches = prefill_step(params, prompt, extra)
        memory = model.encode(params, extra) if L_enc else None
        serve_step(params, logits[:, -1].argmax(-1)[:, None],
                   grow_caches(caches, 1), memory=memory)
        del logits, caches, memory
        torch.cuda.synchronize()
        memory = None
        if L_enc:
            before = kernel_lib.launch_counts()
            t = time.perf_counter()
            memory = model.encode(params, extra)
            torch.cuda.synchronize()
            out["encode_ms"] = (time.perf_counter() - t) * 1e3
            expect_launches(f"{label} encode", launch_delta(before),
                            {"flash_attention": L_enc})
        kernel_lib.reset_launch_counts()
        t = time.perf_counter()
        logits, caches = prefill_step(params, prompt, extra)
        torch.cuda.synchronize()
        out["prefill_ms"] = (time.perf_counter() - t) * 1e3
        prefill_counts = kernel_lib.launch_counts()
        expect_launches(f"{label} prefill", prefill_counts,
                        {"flash_attention": L + L_enc})
        if not torch.isfinite(logits).all():
            fail(f"{label}: non-finite prefill logits")
        caches = grow_caches(caches, MM_STEPS)
        nxt = logits[:, -1].argmax(-1)[:, None]
        tokens = [nxt]
        kernel_lib.reset_launch_counts()
        per_step = {"decode_attention": L * (2 if L_enc else 1)}
        t = time.perf_counter()
        for _ in range(MM_STEPS):
            before = kernel_lib.launch_counts()
            nxt, caches = serve_step(params, nxt, caches, memory=memory)
            expect_launches(f"{label} serve step", launch_delta(before),
                            per_step)
            tokens.append(nxt)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        serve_counts = kernel_lib.launch_counts()
        out["decode_device_ms"] = step_device_ms(
            lambda: serve_step(params, nxt, caches, memory=memory))
    tokens = torch.cat(tokens, 1).cpu()
    if tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        fail(f"{label}: a greedy token outside the vocabulary")
    out.update(decode_step_ms=decode_s / MM_STEPS * 1e3,
               tokens_per_s=MM_BATCH * MM_STEPS / decode_s,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    enc = (f"encode {out['encode_ms']:.2f} ms ({L_enc} layers, "
           f"{MM_BATCH} x {cfg.frontend_tokens} frames), " if L_enc else "")
    print(f"[{label}] {enc}prefill step {out['prefill_ms']:.2f} ms "
          f"({MM_BATCH} x {MM_PROMPT} tokens"
          f"{f' behind {cfg.frontend_tokens} patches' if not L_enc else ''}"
          f"{', encoding included' if L_enc else ''}), {MM_STEPS} serve "
          f"steps at {out['decode_step_ms']:.2f} ms a step "
          f"({out['decode_device_ms']:.2f} ms of it kernels on the card, "
          f"idle {1 - out['decode_device_ms'] / out['decode_step_ms']:.1%}; "
          f"{out['tokens_per_s']:.1f} tokens/s), peak "
          f"{out['peak_gb']:.2f} GB allocated; launches: prefill "
          f"{ {k: v for k, v in prefill_counts.items() if v} }, serve "
          f"{ {k: v for k, v in serve_counts.items() if v} }; greedy "
          f"tokens of row 0: {tokens[0].tolist()}")
    del logits, caches, nxt
    if L_enc:
        out["cross_kv_ms"] = time_cross_kv(params, memory)
        print(f"[{label}] a decode step's cross-attention K/V of the whole "
              f"memory ({L} layers x 2 projections of {MM_BATCH} x "
              f"{cfg.frontend_tokens} x {cfg.d_model}): "
              f"{out['cross_kv_ms']:.3f} ms (CUDA events) of the "
              f"{out['decode_step_ms']:.2f} ms step")
    control = ({"label": "the memory rolled by one row",
                "memory": torch.roll(memory, 1, dims=0)} if L_enc else
               {"label": "the patch embeddings shifted by one position",
                "extra": torch.roll(extra, 1, dims=1)})
    out.update(mm_forced(model, params, toks, extra, memory, label,
                         control))
    out["wall_s"] = time.perf_counter() - t0
    del model, params, memory, extra, control
    torch.cuda.synchronize()
    left = torch.cuda.memory_allocated() / 1e9
    if left > 0.5:
        fail(f"{label}: {left:.2f} GB still allocated after the path")
    torch.cuda.empty_cache()
    return {"prefill": prefill_counts, "serve": serve_counts, "row": out}


def phase_multimodal() -> dict:
    """The vlm and audio families at full width and depth on the card:
    internvl2-1b (8 rows of 256 patch embeddings and a 64-token prompt)
    and seamless-m4t-large-v2 (8 rows of 1024 frames through the 24-layer
    encoder, a 64-token decoder prompt, cross-attention in all 24 decoder
    layers at every step), each through ``serve_multimodal``. Returns
    {path: launches in its prefill and serve} (summed)."""
    counts = {}
    for arch, label in (("internvl2-1b", "internvl2"),
                        ("seamless-m4t-large-v2", "seamless")):
        res = serve_multimodal(arch, label)
        counts[label] = {k: res["prefill"][k] + res["serve"][k]
                         for k in res["serve"]}
        print(f"[{label} summary] " + json.dumps(res["row"]))
    return counts


# ---------------------------------------------------------------------------
# phase 8: train
# ---------------------------------------------------------------------------

#: where the train phase runs (the CPU rehearsal takes the CPU)
# ---------------------------------------------------------------------------
# long: qwen2-moe-a2.7b at long_500k through the launch layer's bundle

LONG_DEVICE = "cuda"
#: the correctness run's depth (f32, full width): the prefix prefilled
#: (two short of the ring: the serve steps wrap it) and the serve steps
LONG_CHECK_LAYERS = 2
LONG_PREFIX = LONG_CONTEXT_WINDOW - 2
LONG_STEPS = 8
#: f32 through 2 layers at S ~ 8200: summation order only (1.79e-5 and
#: the ring 1.20e-5, PERF.md); the window-edge controls must miss it
LONG_ATOL = 1e-4
#: the controls: the same steps decoded on rings one slot shorter and one
#: longer than the window, so that the decode mask's window edge is off
#: by one key either way from the prefill's
LONG_CONTROL_SLOTS = (-1, 1)
#: the full-depth bf16 run: a prompt that wraps the ring in its prefill,
#: then greedy serve steps
LONG_PROMPT = 12000
LONG_SERVE_STEPS = 8


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


#: teacher-forced decode steps of the decode bundle on a mesh of one rank,
#: held bitwise against the unsharded bundle
LONG_MESH_STEPS = 4
#: the dry run this host runs once, in a subprocess: the sequence-split
#: decode on the 16 x 16 mesh (a fake group of 256 ranks in one process)
DRYRUN_ARGS = ("--arch", "qwen3-moe", "--shape", "decode_32k")
_CARD = []


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    if not _CARD:
        _CARD.append(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
            if torch.cuda.is_available() else "no card (a CPU rehearsal)")
    return _CARD[0]


def count_step(fn):
    """(a ``StepCounter`` with its op log, the output) of ``fn()``."""
    with StepCounter(log=True) as c:
        out = fn()
    return c, out


def same_counts(label: str, on_card, on_meta) -> None:
    """Fail unless the card's count of a step and the count of the same
    step on ``meta`` agree: FLOPs by dtype, HBM bytes and every kernel's
    calls, FLOPs and bytes. On a mismatch print the ops counted apart."""
    a, b = on_card.counts, on_meta.counts
    if (a.flops_by_dtype, a.hbm_bytes, a.kernels) == \
            (b.flops_by_dtype, b.hbm_bytes, b.kernels):
        print(f"[roofline] {label}: the card's count equals the meta "
              f"count: {a.flops:.6e} FLOPs {a.flops_by_dtype}, "
              f"{a.hbm_bytes:.6e} HBM bytes, kernels "
              f"{json.dumps(a.kernels)}, {a.aten_ops} aten ops")
        return
    apart = {"card only": sorted(on_card.ops - on_meta.ops),
             "meta only": sorted(on_meta.ops - on_card.ops)}
    print(f"[roofline] {label}: counted apart (op, FLOPs, bytes): "
          + json.dumps({k: [list(x) for x in v[:40]]
                        for k, v in apart.items()}))
    fail(f"{label}: the card's count ({a.flops_by_dtype}, {a.hbm_bytes} "
         f"bytes, {a.kernels}) differs from the meta count "
         f"({b.flops_by_dtype}, {b.hbm_bytes}, {b.kernels})")


def roofline_share(label: str, counts, ms: float) -> dict:
    """The step's least time by ``roofline.analyze`` (published H100 SXM
    peaks at 700 W, f32 at the SIMT rate: TF32 is off here) beside its
    measured ``ms``, and the share."""
    r = roofline.analyze(label, counts, 0.0, 1)
    bound = r.bound_s * 1e3
    share = bound / ms if ms > 0 else float("nan")
    print(f"[roofline] {label} on {card()}: {ms:.3f} ms measured (CUDA "
          f"events, warmed up); least time {bound:.3f} ms, bound by "
          f"{r.dominant} (compute {r.compute_s * 1e3:.3f}, memory "
          f"{r.memory_s * 1e3:.3f}, collective {r.collective_s * 1e3:.3f} "
          f"ms); share {share:.1%}")
    return dict(measured_ms=ms, bound_ms=bound, dominant=r.dominant,
                compute_ms=r.compute_s * 1e3, memory_ms=r.memory_s * 1e3,
                collective_ms=r.collective_s * 1e3, share=share,
                flops=counts.flops, hbm_bytes=counts.hbm_bytes,
                kernels=counts.kernels, card=card())


def long_roofline(cfg, shape, b, params, caches, prompt, tok: int) -> dict:
    """A serve step of the full-depth bundle and the ``LONG_PROMPT``-token
    prefill, each counted on the card and on ``meta`` from a twin of the
    same bundle (``device="meta"``, its abstract arguments): the counts
    must agree (``same_counts``); then each timed (CUDA events, warmed
    up) beside its least time (``roofline_share``)."""
    mb = build_bundle(cfg, shape, dtype=torch.bfloat16, device="meta",
                      attn_impl="flash")
    mparams, _, mcaches = mb.abstract_args
    tok = torch.tensor([[tok]], device=b.model.device)
    prefill, mprefill = make_prefill_step(b.model), \
        make_prefill_step(mb.model)
    mtok = meta(tuple(tok.shape), tok.dtype)
    mprompt = meta(tuple(prompt.shape), prompt.dtype)
    out = {}
    for label, run, mrun, iters in (
            ("long serve step", lambda: b.step_fn(params, tok, caches),
             lambda: mb.step_fn(mparams, mtok, mcaches), 10),
            (f"long prefill 1 x {LONG_PROMPT}",
             lambda: prefill(params, prompt)[0],
             lambda: mprefill(mparams, mprompt)[0], 3)):
        on_card, _ = count_step(run)
        on_meta, _ = count_step(mrun)
        same_counts(label, on_card, on_meta)
        out[label] = roofline_share(label, on_card.counts,
                                    time_ms(run, iters=iters, warmup=1))
    return out


def long_mesh(cfg, shape, b, params, caches, tokens) -> dict:
    """The same decode bundle built on a (1, 1) ``make_host_mesh`` over an
    NCCL group of one rank (gloo on the CPU), on the same weights (at one
    rank every shard is the whole tensor): ``LONG_MESH_STEPS``
    teacher-forced steps of ``sharded_decode`` from a copy of the same
    ring, each step's logits bitwise the unsharded bundle's, then both
    bundles' serve steps the same greedy token."""
    DepGroups.single("nccl" if LONG_DEVICE == "cuda" else "gloo")
    mesh = make_host_mesh(model=1, device_type=LONG_DEVICE)
    mb = build_bundle(cfg, shape, mesh=mesh, dtype=torch.bfloat16,
                      device=LONG_DEVICE, attn_impl="flash")
    if mb.model.ctx.tp is None or mb.model.ctx.moe_impl != "dep":
        fail("long mesh: the bundle on a mesh is not tensor-parallel DEP")
    one = [{k: v.clone() for k, v in c.items()} for c in caches]
    two = [{k: v.clone() for k, v in c.items()} for c in caches]
    forced = torch.tensor(tokens, device=b.model.device)
    for j in range(LONG_MESH_STEPS):
        t = forced[j].reshape(1, 1)
        want, one = b.model.decode_step(params, t, one)
        got, two = sharded_decode(mb.model, mesh, mb.placements[0], params,
                                  t, two)
        if not torch.equal(got, want):
            fail(f"long mesh: step {j}'s logits differ from the unsharded "
                 f"bundle's by {float((got - want).abs().max()):.3e}")
    t = forced[LONG_MESH_STEPS].reshape(1, 1)
    nxt, _ = b.step_fn(params, t, one)
    mnxt, _ = mb.step_fn(params, t, two)
    if not torch.equal(nxt, mnxt):
        fail(f"long mesh: greedy tokens {nxt.tolist()} / {mnxt.tolist()}")
    del one, two
    torch.distributed.destroy_process_group()
    print(f"[long mesh] {mb.name} on a (1, 1) mesh over "
          f"{'NCCL' if LONG_DEVICE == 'cuda' else 'gloo'}: "
          f"{LONG_MESH_STEPS} teacher-forced decode steps bitwise the "
          f"unsharded bundle's logits, then the same greedy token "
          f"{int(nxt[0, 0])}")
    return dict(steps=LONG_MESH_STEPS, bitwise=True, token=int(nxt[0, 0]))


def card_dryrun() -> dict:
    """``python -m repro_torch.launch.dryrun`` once, in a subprocess on
    this host, at ``DRYRUN_ARGS`` (the sequence-split decode of
    qwen3-moe's four KV heads over the 16-wide model axis): a fake group
    of 256 ranks under this torch, nothing on the card. Fails unless it
    prints a record with the reference's keys whose decode took the
    sequence-split path (no decode kernel; three all_reduce a layer)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    if res.returncode:
        fail(f"dryrun: exit {res.returncode}: {res.stderr[-3000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    keys = ("arch", "shape", "mesh", "mode", "ok", "accum_steps",
            "arg_bytes_per_device", "temp_bytes_per_device",
            "peak_gb_per_device", "flops_per_device",
            "hbm_bytes_per_device", "collective_bytes_per_device",
            "collective_counts", "collective_bytes_by_kind", "compute_ms",
            "memory_ms", "collective_ms", "dominant", "model_flops",
            "useful_flops_ratio")
    missing = [k for k in keys if k not in rec]
    layers = get_config("qwen3-moe").num_layers
    if missing or not rec["ok"] or "decode_attention" in rec["kernel_work"] \
            or rec["collective_counts"].get("all-reduce", 0) < 3 * layers:
        fail(f"dryrun: a record without {missing} or off the "
             f"sequence-split path: {json.dumps(rec)}")
    print(f"[dryrun] {' '.join(DRYRUN_ARGS)} in a subprocess "
          f"({time.perf_counter() - t0:.1f} s): " + json.dumps(rec))
    return rec


def long_check(cfg, shape) -> dict:
    """The correctness half of ``phase_long``: the adapted config cut to
    ``LONG_CHECK_LAYERS`` at full width, f32, capacity factor E / top_k
    (prefills of different lengths then drop nothing, as one token a
    step does not). The bundle's model prefills ``LONG_PREFIX`` tokens
    (``make_prefill_step``: caches of the prompt's length, grown to the
    bundle's ring of the window), then decodes ``LONG_STEPS`` tokens
    across the ring's wrap; each step's logits must equal the last
    logits of a prefill of the whole prompt so far within ``LONG_ATOL``,
    and the ring after the steps the rolled ring of that prefill. The
    controls decode the same steps from the same prefill on rings of W
    - 1 and W + 1 slots (``LONG_CONTROL_SLOTS``: the window edge one key
    off either way), and must miss ``LONG_ATOL``."""
    t0 = time.perf_counter()
    ccfg = no_drop(dataclasses.replace(cfg, num_layers=LONG_CHECK_LAYERS))
    b = build_bundle(ccfg, shape, dtype=torch.float32,
                     device=LONG_DEVICE, attn_impl="flash")
    model = b.model
    params = model.init(generator_for(model.device, 0))
    prefill = make_prefill_step(model)
    P, W = LONG_PREFIX, ccfg.sliding_window
    toks = torch.from_numpy(np.random.RandomState(7).randint(
        0, ccfg.vocab_size, size=(1, P + LONG_STEPS))).to(model.device)
    before = kernel_lib.launch_counts()
    _, short = prefill(params, toks[:, :P])
    caches = grow_caches(short, W - P)
    if [tuple(c["k"].shape) for c in caches] != \
            [tuple(c["k"].shape) for c in b.abstract_args[2]]:
        fail("long: the grown prefill caches are not the bundle's ring")
    worst, wants = 0.0, []
    for j in range(LONG_STEPS):
        logits, caches = model.decode_step(params, toks[:, P + j:P + j + 1],
                                           caches)
        want, pre = prefill(params, toks[:, :P + j + 1])
        wants.append(want)
        if not torch.isfinite(logits).all():
            fail(f"long: non-finite logits at decode step {j}")
        err = float((logits - want).abs().max())
        worst = max(worst, err)
        if err > LONG_ATOL:
            fail(f"long: decode step {j} (position {P + j}) logits differ "
                 f"from the prefill's by {err:.3e} > {LONG_ATOL}")
    ring_err = max(float((caches[i][n] - pre[i][n]).abs().max())
                   for i in range(len(caches)) for n in ("k", "v"))
    if ring_err > LONG_ATOL or any(int(c["index"]) != P + LONG_STEPS
                                   for c in caches):
        fail(f"long: the ring after the steps differs from the rolled "
             f"prefill's by {ring_err:.3e} (indices "
             f"{[int(c['index']) for c in caches]})")
    L = LONG_CHECK_LAYERS
    expect_launches("long check", launch_delta(before), {
        "flash_attention": L * (1 + LONG_STEPS),
        "moe_gemm": L * (1 + 2 * LONG_STEPS)})
    controls = {}
    for d in LONG_CONTROL_SLOTS:
        ring = grow_caches(short, W + d - P)
        err = 0.0
        for j in range(LONG_STEPS):
            logits, ring = model.decode_step(
                params, toks[:, P + j:P + j + 1], ring)
            err = max(err, float((logits - wants[j]).abs().max()))
        controls[W + d] = err
        if err <= LONG_ATOL:
            fail(f"long: the control on a ring of {W + d} slots (the "
                 f"window edge one key off) reads {err:.3e}, within "
                 f"{LONG_ATOL}")
        del ring
    print(f"[long] {ccfg.name} adapted to {shape.name} ({ccfg.attention}, "
          f"window {W}) at full width cut to {L} layers, f32, capacity "
          f"factor {ccfg.moe.capacity_factor}: {LONG_STEPS} decode steps "
          f"from position {P} across the {W}-slot ring's wrap match a "
          f"prefill of the whole prompt (max |dlogit| {worst:.2e}, atol "
          f"{LONG_ATOL}); the ring after them matches the rolled "
          f"{P + LONG_STEPS}-token prefill's (max diff {ring_err:.2e}); "
          f"the controls on rings of W - 1 and W + 1 slots (the window edge "
          f"one key off) miss it: max |dlogit| "
          f"{ {k: f'{v:.3e}' for k, v in controls.items()} }; "
          f"{time.perf_counter() - t0:.1f} s")
    del model, params, caches, pre, short, wants
    return dict(layers=L, worst_logit=worst, ring_err=ring_err,
                controls=controls)


def phase_long() -> dict:
    """qwen2-moe-a2.7b x ``SHAPES["long_500k"]`` through the launch
    layer: ``adapt_for_shape`` gives it a sliding window of 8192 over a
    ring cache, and ``build`` its decode bundle. ``long_check`` first (f32,
    cut depth); then the bundle at full width and depth (24 layers) in
    bf16: its ``abstract_args`` materialised (weights from seed 0, the
    caches of ``decode_cache_specs`` as zeros on the card), a
    ``LONG_PROMPT``-token prompt prefilled (flash with the window; the
    ring rolls) into those caches, then ``LONG_SERVE_STEPS`` greedy serve
    steps of the bundle's ``step_fn``; twice, with the same tokens. The
    launches are counted over the two runs (flash 24 a prefill, the
    expert GEMM 24 a prefill and a step, nothing else: ring decode is
    the plain masked SDPA, as in the reference); then the expert GEMM at
    every (E, C) the run gave it and flash at the prompt's shape with
    the window, each against its plain version. Prints ms a serve step,
    the ring's bytes and the peak memory beside the bytes of the
    unadapted cache. Returns the launches."""
    t0 = time.perf_counter()
    shape = SHAPES["long_500k"]
    base = get_config("qwen2-moe-a2.7b")
    cfg = adapt_for_shape(base, shape)
    if (cfg.attention, cfg.sliding_window) != ("sliding",
                                               LONG_CONTEXT_WINDOW):
        fail(f"long: adapt_for_shape gave {cfg.attention} window "
             f"{cfg.sliding_window}")
    check = long_check(cfg, shape)
    if LONG_DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    unadapted = _nbytes(decode_cache_specs(make_model(base, device="meta"),
                                           base, shape))
    b = build_bundle(cfg, shape, dtype=torch.bfloat16,
                     device=LONG_DEVICE, attn_impl="flash")
    model = b.model
    params_abs, _, caches_abs = b.abstract_args
    params = model.init(generator_for(model.device, 0))
    got = [(tuple(t.shape), t.dtype) for t in tree_leaves(params)]
    if got != [(tuple(t.shape), t.dtype) for t in tree_leaves(params_abs)]:
        fail("long: the drawn weights are not the bundle's abstract ones")
    caches = [{k: torch.zeros(v.shape, dtype=v.dtype, device=model.device)
               for k, v in c.items()} for c in caches_abs]
    ring = _nbytes(caches)
    prefill = make_prefill_step(model)
    prompt = torch.from_numpy(np.random.RandomState(8).randint(
        0, cfg.vocab_size, size=(1, LONG_PROMPT))).to(model.device)

    def run():
        logits, pre = prefill(params, prompt)
        for c, p in zip(caches, pre):
            for k in c:
                c[k].copy_(p[k])
        del pre
        tok = logits[:, -1].argmax(-1)[:, None]
        out, ms = [int(tok[0, 0])], []
        cs = caches
        for _ in range(LONG_SERVE_STEPS):
            sync_long()
            t = time.perf_counter()
            tok, cs = b.step_fn(params, tok, cs)
            out.append(int(tok[0, 0]))
            ms.append((time.perf_counter() - t) * 1e3)
        if int(cs[0]["index"]) != LONG_PROMPT + LONG_SERVE_STEPS:
            fail(f"long: cache index {int(cs[0]['index'])}")
        return out, ms

    before = kernel_lib.launch_counts()
    with GemmWidths() as widths:
        tokens, step_ms = run()
        again, _ = run()
    counts = launch_delta(before)
    L = cfg.num_layers
    expect_launches("long", counts, {
        "flash_attention": 2 * L,
        "moe_gemm": 2 * L * (1 + LONG_SERVE_STEPS)})
    if tokens != again:
        fail(f"long: two runs give different tokens {tokens} / {again}")
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if LONG_DEVICE == "cuda" else 0.0)
    step = float(np.median(step_ms))
    row = dict(config=f"{cfg.name} {cfg.attention} window "
               f"{cfg.sliding_window}", layers=L, prompt=LONG_PROMPT,
               tokens=tokens, step_ms=step, step_ms_all=step_ms,
               ring_gb=ring / 1e9, unadapted_gb=unadapted / 1e9,
               peak_gb=peak, check=check)
    print(f"[long] {b.name}: {L} layers at full width, bf16, "
          f"{_nbytes(params) / 1e9:.2f} GB of weights; a {LONG_PROMPT}-token "
          f"prompt prefilled into the bundle's ring (the "
          f"{cfg.sliding_window}-slot ring of {ring / 1e9:.3f} GB, where "
          f"the unadapted {shape.seq_len}-position cache would take "
          f"{unadapted / 1e9:.1f} GB), then {LONG_SERVE_STEPS} greedy serve "
          f"steps at {step:.2f} ms a step (median; all "
          f"{', '.join(f'{x:.2f}' for x in step_ms)}), tokens {tokens} in "
          f"both runs; peak {peak:.2f} GB allocated; launches {counts}")
    row["roofline"] = long_roofline(cfg, shape, b, params, caches, prompt,
                                    tokens[-1])
    row["mesh"] = long_mesh(cfg, shape, b, params, caches, tokens)
    shapes = widths.shapes
    experts = {cfg.moe.num_experts: params["layers"][0]["moe"]["experts"]}
    del model, params, caches, prefill
    if LONG_DEVICE == "cuda":
        torch.cuda.empty_cache()
    check_dep_widths(experts, shapes, torch.device(LONG_DEVICE), "long")
    del experts
    if LONG_DEVICE == "cuda":
        gen = torch.Generator(device="cuda")
        gen.manual_seed(9)
        row["flash"] = check_flash_shape(
            gen, "long prefill", 1, LONG_PROMPT, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, window=cfg.sliding_window)
        torch.cuda.empty_cache()
    row["dryrun"] = card_dryrun()
    row["wall_s"] = time.perf_counter() - t0
    print("[long summary] " + json.dumps(row))
    return counts


def sync_long() -> None:
    if LONG_DEVICE == "cuda":
        torch.cuda.synchronize()


TRAIN_DEVICE = "cuda"
#: qwen2-moe-a2.7b layers trained on one card: a layer holds 0.571 B
#: parameters and the 151936-token embedding and head 0.622 B, so 8 layers
#: hold 5.19 B; bf16 parameters, gradients and two bf16 AdamW states take 8
#: bytes a parameter, 41.5 GB (the 24 layers would need 114 GB)
TRAIN_LAYERS = 8
#: rows, tokens a row and steps of the full-width run
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 512, 6
#: the expert GEMM's autograd Function at the train step's shape: the
#: relative L2 of its forward and of each gradient against autograd of
#: ``moe_gemm_ref`` on float32 copies of the same inputs. f32: summation
#: order (the sound readings 6.5e-8 to 1.3e-7). bf16: the backward rounds
#: g, u and the elementwise terms to bf16 before each product and the
#: forward rounds the activation (see GEMM_TOL); the sound readings were
#: 2.35e-3 (y) to 3.88e-3 (dx) on the H100 and the controls (expert
#: e+1's Wd, silu' dropped) 0.718 at least (PERF.md, training), so 2e-2
#: is 5.2x the worst sound reading and 36x under the least control
TRAIN_GEMM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: the smoke model's step on the card (kernel forward) against the CPU
#: (plain versions), f32: relative L2 of every gradient leaf and relative
#: difference of the loss (the worst leaf read 2.84e-6 and the
#: rolled-experts control 1.41 on the H100)
TRAIN_SMALL_TOL = 1e-4
#: the train loop end to end through the entry point, on the card: each
#: run's arguments and the least fall of its loss (nats) from the mean of
#: its first 5 steps to its final loss (the mean of the last 10). The
#: 100m preset's 200 steps, the reference example's deliverable run, fall
#: 0.41 nat on the card and as much in the reference's own run on the
#: CPU (examples/train_small.py, other weights; PERF.md): its loss
#: stays near ln(32000) = 10.37, the bigram table not yet learnt, so it is
#: held to the reference test's 0.2 nat; the tiny preset learns the
#: table in as many steps (6.72 -> 3.39 on the CPU), held to 1 nat
TRAIN_LOOP_RUNS = ((["--preset", "100m", "--steps", "200"], 0.2),
                   (["--preset", "tiny", "--steps", "200"], 1.0))


def rel_l2(got, want) -> float:
    g, w = got.detach().float().cpu(), want.detach().float().cpu()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def gemm_backward_without_silu_grad(x, wg, wu, wd, dy):
    """A control: ``moe_gemm_backward`` with silu'(g) dropped from dg."""
    dt = x.dtype
    g, u = torch.bmm(x, wg).float(), torch.bmm(x, wu).float()
    dh = torch.bmm(dy, wd.transpose(1, 2)).float()
    dg, du = (dh * u).to(dt), (dh * F.silu(g)).to(dt)
    xt = x.transpose(1, 2)
    dx = (torch.bmm(dg, wg.transpose(1, 2)).float()
          + torch.bmm(du, wu.transpose(1, 2)).float()).to(dt)
    wd_grad = torch.bmm((F.silu(g) * u).to(dt).transpose(1, 2), dy)
    return dx, torch.bmm(xt, dg), torch.bmm(xt, du), wd_grad


GRAD_NAMES = ("y", "dx", "dW_gate", "dW_up", "dW_down")


def train_gemm_shape():
    """(E, C, M, H) of the full-width run's expert GEMM: the capacity of
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens."""
    cfg = get_config("qwen2-moe-a2.7b")
    C = moe_lib.expert_capacity(TRAIN_BATCH * TRAIN_SEQ, cfg.moe)
    return cfg.moe.num_experts, C, cfg.d_model, cfg.moe.expert_ffn_dim


def time_train_gemm(x, wg, wu, wd, dy) -> dict:
    """CUDA-event ms of the kernel's forward (no graph), its backward
    (``moe_gemm_backward``), forward + backward through the Function, and
    autograd of the plain version and of three ``torch.bmm`` + SiLU, with
    the card's bound of each."""
    E, C, M = x.shape
    H = wg.shape[-1]
    es = x.element_size()
    # aliases that require a gradient, for the timings under autograd
    ops = tuple(t.detach().requires_grad_() for t in (x, wg, wu, wd))

    def lib(x, wg, wu, wd):
        return torch.bmm(F.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)

    with torch.no_grad():
        fwd = time_ms(lambda: moe_gemm(x, wg, wu, wd))
        lib_fwd = time_ms(lambda: lib(x, wg, wu, wd))
    bwd = time_ms(lambda: moe_gemm_backward(x, wg, wu, wd, dy))
    both = time_ms(lambda: torch.autograd.grad(moe_gemm(*ops), ops, dy))
    lib_both = time_ms(lambda: torch.autograd.grad(lib(*ops), ops, dy))
    plain_both = time_ms(lambda: torch.autograd.grad(
        moe_gemm_ref(*ops), ops, dy), iters=3, warmup=1)
    back = profile_breakdown(lambda: moe_gemm_backward(x, wg, wu, wd, dy),
                             f"train backward {x.dtype}")
    emh, ecm = E * M * H, E * C * M
    b_fwd = work_bound(moe_gemm_work, x, wg, wu, wd)
    b_bwd = bound_ms((3 * ecm + 6 * emh) * es, 16.0 * ecm * H, x.dtype)
    b_both = bound_ms((5 * ecm + 9 * emh) * es, 22.0 * ecm * H, x.dtype)
    return dict(ms=fwd, backward_ms=bwd, fwd_bwd_ms=both,
                library_ms=lib_fwd, library_fwd_bwd_ms=lib_both,
                plain_fwd_bwd_ms=plain_both, backward_profile=back,
                bound_ms=b_fwd[0],
                bound_by=b_fwd[1], backward_bound_ms=b_bwd[0],
                backward_bound_by=b_bwd[1], fwd_bwd_bound_ms=b_both[0],
                fwd_bwd_bound_by=b_both[1])


def check_train_gemm() -> dict:
    """The expert GEMM's autograd Function at the full-width run's shape
    in f32 and bf16: forward and the four gradients against autograd of
    ``moe_gemm_ref`` on float32 copies (``TRAIN_GEMM_TOL``), one kernel
    launch a forward, and in bf16 two controls (expert e+1's Wd; silu'
    dropped), each of which must exceed the limit in every output it
    changes; then the timings. Returns the report row."""
    E, C, M, H = train_gemm_shape()
    gen = generator_for(TRAIN_DEVICE, 0)
    row = {"shape": f"E={E} C={C} M={M} H={H}"}
    print(f"[train] expert GEMM Function at {row['shape']}")

    def r(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=TRAIN_DEVICE)
                * scale).to(dtype)

    for dtype in (torch.float32, torch.bfloat16):
        x, dy = r((E, C, M), dtype), r((E, C, M), dtype)
        wg, wu = r((E, M, H), dtype, M ** -0.5), r((E, M, H), dtype, M ** -0.5)
        wd = r((E, H, M), dtype, H ** -0.5)
        ops32 = [t.float().requires_grad_() for t in (x, wg, wu, wd)]
        y32 = moe_gemm_ref(*ops32)
        want = (y32.detach(),) + torch.autograd.grad(y32, ops32,
                                                     dy.float())
        del ops32, y32
        ops = (x, wg, wu, wd)
        for t in ops:
            t.requires_grad_()
        before = kernel_lib.launch_counts()
        y = gemm_ops.moe_gemm(*ops)
        if launch_delta(before)["moe_gemm"] != 1 or y.grad_fn is None:
            fail("train: moe_gemm under autograd did not launch the kernel "
                 "once through its Function")
        got = (y.detach(),) + torch.autograd.grad(y, ops, dy)
        del y
        tol = TRAIN_GEMM_TOL[dtype]
        errs = {n: rel_l2(g, w) for n, g, w in zip(GRAD_NAMES, got, want)}
        print(f"  {dtype}: relative L2 against autograd of the plain "
              f"version " + ", ".join(f"{n} {e:.3e}" for n, e in
                                      errs.items()) + f" (limit {tol})")
        if not all(torch.isfinite(g).all() for g in got) \
                or max(errs.values()) > tol:
            fail(f"train: the expert GEMM Function disagrees with autograd "
                 f"of its plain version in {dtype}: {errs}")
        key = "f32" if dtype == torch.float32 else "bf16"
        row[f"rel_l2_{key}"] = errs
        if dtype == torch.bfloat16:
            # each control and the gradients its fault reaches
            with torch.no_grad():
                controls = {
                    "expert e+1's Wd": (moe_gemm_backward(
                        x, wg, wu, torch.roll(wd, -1, dims=0), dy),
                        ("dx", "dW_gate", "dW_up")),
                    "silu' dropped": (gemm_backward_without_silu_grad(
                        x, wg, wu, wd, dy), ("dx", "dW_gate"))}
            ratios = {}
            for label, (wrong, reached) in controls.items():
                errs_c = {n: rel_l2(w, t) for n, w, t in
                          zip(GRAD_NAMES[1:], wrong, want[1:])}
                ratios[label] = min(errs_c[n] for n in reached) / tol
                print(f"  control ({label}): relative L2 "
                      + ", ".join(f"{n} {e:.3e}" for n, e in
                                  errs_c.items())
                      + f"; least over {', '.join(reached)} "
                      f"{ratios[label]:.1f}x the limit")
                if ratios[label] <= 1:
                    fail(f"train: the control ({label}) passes "
                         f"TRAIN_GEMM_TOL: the check cannot see it")
            row["control_worst_ratio"] = ratios
        del got, want
        for t in ops:
            t.requires_grad_(False)
        timing = time_train_gemm(x, wg, wu, wd, dy)
        if timing:
            row[key] = timing
            print(f"  {key}: forward kernel {timing['ms']:.3f} ms (bound "
                  f"{timing['bound_ms']:.3f} by {timing['bound_by']}; "
                  f"torch.bmm x3 {timing['library_ms']:.3f}), backward "
                  f"{timing['backward_ms']:.3f} ms (bound "
                  f"{timing['backward_bound_ms']:.3f} by "
                  f"{timing['backward_bound_by']}), forward + backward "
                  f"{timing['fwd_bwd_ms']:.3f} ms against autograd of "
                  f"torch.bmm x3 + SiLU {timing['library_fwd_bwd_ms']:.3f} "
                  f"and of the plain version "
                  f"{timing['plain_fwd_bwd_ms']:.3f} (bound "
                  f"{timing['fwd_bwd_bound_ms']:.3f} by "
                  f"{timing['fwd_bwd_bound_by']})")
        del x, wg, wu, wd, dy
        if TRAIN_DEVICE == "cuda":
            torch.cuda.empty_cache()
    return row


def sync() -> None:
    if TRAIN_DEVICE == "cuda":
        torch.cuda.synchronize()


def profile_breakdown(fn, label: str, top: int = 8) -> dict:
    """Calls of ``fn`` under torch.profiler, one a trace, until two traces
    hold the same number of device events (the profiler drops some now
    and then, PERF.md §7), four at most: the last call's wall ms (host
    clock to a device sync), its kernels' device ms (summed; one stream)
    and the card's idle share of the wall time, and the ``top`` kernels
    by device time, printed. Without two traces that agree the device
    numbers read None ("not measured"), not a short sum. ``calls`` is how
    many times ``fn`` ran."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    seen = []
    for _ in range(4):
        sync()
        with torch.profiler.profile(activities=acts) as prof:
            t = time.perf_counter()
            fn()
            sync()
            wall = (time.perf_counter() - t) * 1e3
        by_name = {}
        for e in device_events(prof):
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
        count = sum(n for n, _ in by_name.values())
        if (count and count in seen) or TRAIN_DEVICE != "cuda":
            seen.append(count)
            break
        seen.append(count)
    else:
        print(f"[{label}] profiled: wall {wall:.2f} ms; device time not "
              f"measured (device events a trace: {seen})")
        return dict(wall_ms=wall, device_ms=None, idle=None, top=None,
                    calls=len(seen))
    busy = sum(us for _, us in by_name.values()) / 1e3
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    print(f"[{label}] profiled: wall {wall:.2f} ms, kernels {busy:.2f} ms "
          f"on the device ({count} device events; traces {seen}), idle "
          f"{1 - busy / wall:.1%}; top kernels:")
    for name, (n, us) in ranked:
        print(f"  {us / 1e3:8.3f} ms {n:5d}x  {name[:90]}")
    return dict(wall_ms=wall, device_ms=busy, idle=1 - busy / wall,
                top=[(name[:90], n, us / 1e3) for name, (n, us) in ranked],
                calls=len(seen))


def check_gradients(grads) -> None:
    """Fail unless every gradient leaf is finite and not all zero: a
    graph cut by a kernel without a backward leaves its weights' gradient
    at zero."""
    named = list(named_leaves(grads))
    bad = torch.stack([(~torch.isfinite(g).all()) | (g.abs().amax() == 0)
                       for _, g in named])
    bad = [n for (n, _), b in zip(named, bad.tolist()) if b]
    experts = [n for n, _ in named if ".experts." in n or ".router." in n]
    if bad:
        fail(f"train: {len(bad)} gradient leaves non-finite or all zero "
             f"after the first backward: {bad[:8]}")
    print(f"[train] first backward: all {len(named)} gradient leaves "
          f"finite and non-zero ({len(experts)} of them the layers' "
          f"stacked experts and routers)")


def train_full() -> tuple:
    """qwen2-moe-a2.7b at full width cut to ``TRAIN_LAYERS``, bf16 weights
    from seed 0, ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    Markov tokens (seed 0) with the default AdamW (bf16 states). Step 1
    is ``make_train_step``'s two halves, ``loss_and_grads`` and
    ``apply_updates``, with every gradient leaf checked between them
    (finite, not all zero: a cut graph leaves its weights at zero); steps
    2.. are ``make_train_step``. Every step: the loss and grad norm
    finite, the expert GEMM ``TRAIN_LAYERS`` launches and no other kernel.
    Then one step with ``remat=True``: 2 x ``TRAIN_LAYERS`` launches.
    Returns (launches over the steps, the report row)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                              num_layers=TRAIN_LAYERS)
    model = build_model(cfg, dtype=torch.bfloat16, device=TRAIN_DEVICE)
    params = model.init(generator_for(model.device, 0))
    n_params = sum(t.numel() for t in _leaves(params))
    opt_cfg = AdamWConfig(state_dtype=torch.bfloat16)
    state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    data = MarkovTextDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0))
    batches = [torch.from_numpy(data.sample_batch(s)).to(model.device)
               for s in range(TRAIN_STEPS + 1)]
    want = {"moe_gemm": TRAIN_LAYERS}
    total = {k: 0 for k in kernel_lib.launch_counts()}
    losses, norms, step_s = [], [], []
    if TRAIN_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for s in range(TRAIN_STEPS):
        before = kernel_lib.launch_counts()
        sync()
        t = time.perf_counter()
        if s == 0:
            loss, grads = loss_and_grads(model, params, batches[s])
            check_gradients(grads)
            params, state, gnorm = apply_updates(params, grads, state,
                                                 opt_cfg)
            del grads
            metrics = {"loss": loss, "grad_norm": gnorm}
        else:
            params, state, metrics = step_fn(params, state, batches[s])
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        sync()
        step_s.append(time.perf_counter() - t)
        delta = launch_delta(before)
        expect_launches(f"train step {s}", delta, want)
        for k, v in delta.items():
            total[k] += v
        if not (np.isfinite(losses[-1]) and np.isfinite(norms[-1])):
            fail(f"train: step {s} loss {losses[-1]} grad norm "
                 f"{norms[-1]}")
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if TRAIN_DEVICE == "cuda" else 0.0)
    roof = train_roofline(cfg, step_fn, params, state, batches[TRAIN_STEPS],
                          opt_cfg)
    before = kernel_lib.launch_counts()
    holder = {}

    def one_step():
        holder["out"] = step_fn(params, state, batches[TRAIN_STEPS])

    prof = profile_breakdown(one_step, "train step")
    expect_launches("profiled train steps", launch_delta(before),
                    {"moe_gemm": TRAIN_LAYERS * prof["calls"]})
    params, state = holder.pop("out")[:2]
    remat = build_model(cfg, ctx=ExecutionContext(remat=True),
                        dtype=torch.bfloat16, device=TRAIN_DEVICE)
    before = kernel_lib.launch_counts()
    if TRAIN_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync()
    t = time.perf_counter()
    params, state, m = make_train_step(remat, opt_cfg)(
        params, state, batches[TRAIN_STEPS])
    remat_loss = float(m["loss"])
    sync()
    remat_s = time.perf_counter() - t
    remat_peak = (torch.cuda.max_memory_allocated() / 1e9
                  if TRAIN_DEVICE == "cuda" else 0.0)
    expect_launches("train step with remat", launch_delta(before),
                    {"moe_gemm": 2 * TRAIN_LAYERS})
    step_ms = float(np.median(step_s[1:])) * 1e3
    row = dict(config=f"{cfg.name} {TRAIN_LAYERS} of 24 layers",
               params=n_params, batch=f"{TRAIN_BATCH} x {TRAIN_SEQ}",
               losses=losses, grad_norms=norms,
               step_ms=step_ms, step_ms_all=[x * 1e3 for x in step_s],
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
               peak_gb=peak, profile=prof, remat_step_ms=remat_s * 1e3,
               remat_loss=remat_loss, remat_peak_gb=remat_peak,
               roofline=roof)
    print(f"[train] {row['config']} ({n_params / 1e9:.3f} B params, bf16, "
          f"AdamW bf16 states): losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + f"; grad norms " + ", ".join(f"{v:.3f}" for v in norms)
          + f"; step {step_ms:.1f} ms (median of steps 2-{TRAIN_STEPS}; "
          f"all {', '.join(f'{x * 1e3:.1f}' for x in step_s)}), "
          f"{row['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB; "
          f"remat step {remat_s * 1e3:.1f} ms, peak {remat_peak:.2f} GB, "
          f"expert GEMM {TRAIN_LAYERS} launches a step "
          f"({2 * TRAIN_LAYERS} with remat)")
    del model, remat, params, state, batches, m, metrics, loss
    sync()
    if TRAIN_DEVICE == "cuda":
        left = torch.cuda.memory_allocated() / 1e9
        if left > 0.5:
            fail(f"train: {left:.2f} GB still allocated after the run")
        torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t0
    return total, row


def train_roofline(cfg, step_fn, params, state, batch, opt_cfg) -> dict:
    """One train step counted on the card (it also trains: the weights
    and states move on) and the same step on ``meta`` (a twin model, its
    abstract weights and AdamW states): the counts must agree
    (``same_counts``); then two more steps timed by CUDA events beside the
    step's least time (``roofline_share``)."""
    def run():
        return step_fn(params, state, batch)[2]["loss"]
    on_card, _ = count_step(run)
    twin = build_model(cfg, dtype=torch.bfloat16, device="meta")
    mparams = abstract_params(twin, torch.bfloat16)
    mstate = init_opt_state(mparams, opt_cfg)
    mbatch = meta(tuple(batch.shape), batch.dtype)
    on_meta, _ = count_step(lambda: make_train_step(twin, opt_cfg)(
        mparams, mstate, mbatch))
    same_counts("train step", on_card, on_meta)
    return roofline_share(f"train step {TRAIN_BATCH} x {TRAIN_SEQ}, "
                          f"{TRAIN_LAYERS} layers", on_card.counts,
                          time_ms(run, iters=2, warmup=0))


def train_small() -> dict:
    """One step's loss and gradients of qwen2-moe's smoke model in f32 on
    the card (the expert GEMM kernel and its Function) against the same
    step on the CPU (plain versions), from the same weights and Markov
    tokens: the loss and every gradient leaf within ``TRAIN_SMALL_TOL``
    (relative L2), beside a control (the CPU's expert gradients rolled by
    one expert) that must exceed it in every expert leaf."""
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    cpu = build_model(cfg, dtype=torch.float32, device="cpu")
    p_cpu = cpu.init(generator_for("cpu", 0))
    card = build_model(cfg, dtype=torch.float32, device=TRAIN_DEVICE)
    p_card = params_from_numpy(_to_numpy(p_cpu), TRAIN_DEVICE,
                               torch.float32)
    toks = torch.from_numpy(MarkovTextDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=64, batch_size=4,
        seed=0)).sample_batch(0))
    l_cpu, g_cpu = loss_and_grads(cpu, p_cpu, toks)
    before = kernel_lib.launch_counts()
    l_card, g_card = loss_and_grads(card, p_card, toks.to(card.device))
    n_moe = sum(k == "attn_moe" for k in card.kinds)
    expect_launches("train small step", launch_delta(before),
                    {"moe_gemm": n_moe})
    loss_err = abs(float(l_card) - float(l_cpu)) / abs(float(l_cpu))
    errs = {n: rel_l2(a, b) for (n, a), (_, b) in
            zip(named_leaves(g_card), named_leaves(g_cpu))}
    worst = max(errs, key=errs.get)
    rolled = {n: rel_l2(a, torch.roll(b, 1, dims=0))
              for (n, a), (_, b) in zip(named_leaves(g_card),
                                        named_leaves(g_cpu))
              if ".experts." in n}
    print(f"[train small] {cfg.name} smoke, f32, 4 x 64 tokens: loss "
          f"{float(l_card):.6f} card, {float(l_cpu):.6f} CPU (relative "
          f"{loss_err:.2e}); {len(errs)} gradient leaves, worst relative "
          f"L2 {errs[worst]:.2e} ({worst}); limit {TRAIN_SMALL_TOL}; "
          f"control (expert gradients rolled by one expert) least "
          f"{min(rolled.values()):.3e} over {len(rolled)} leaves")
    if loss_err > TRAIN_SMALL_TOL or errs[worst] > TRAIN_SMALL_TOL:
        fail(f"train small: the card's step disagrees with the CPU's "
             f"(loss {loss_err:.2e}, {worst} {errs[worst]:.2e})")
    if not rolled or min(rolled.values()) <= TRAIN_SMALL_TOL:
        fail("train small: the rolled-experts control is within the limit")
    return dict(loss_rel=loss_err, worst_grad_rel_l2=errs[worst],
                worst_leaf=worst, control_least=min(rolled.values()))


def train_loop(argv: list, drop: float, ckpt: str) -> tuple:
    """``python -m repro_torch.launch.train_small`` (its ``main`` with
    ``argv``, on the card, f32, through the f32 SIMT expert kernel): its
    final loss at least ``drop`` below the mean of its first 5 steps; its
    checkpoint loads back into the preset's parameter tree bit for bit
    (every leaf equal to the file's bits) and is the trained model (its
    loss on the last step's batch within 0.5 nat of the final loss).
    Returns (launches, the report row)."""
    before = kernel_lib.launch_counts()
    argv = list(argv) + ["--ckpt", ckpt]
    if TRAIN_DEVICE != "cuda":
        argv += ["--device", TRAIN_DEVICE]
    args = train_small_cli.build_parser().parse_args(argv)
    res = train_small_cli.main(argv)
    counts = launch_delta(before)
    first = float(np.mean(res.losses[:5]))
    data = MarkovTextDataset(DataConfig(
        vocab_size=train_small_cli.PRESETS[args.preset].vocab_size,
        seq_len=args.seq, batch_size=args.batch, seed=0))
    print(f"[train loop] {args.preset}: losses " + ", ".join(
        f"{v:.3f}" for v in res.losses[::max(args.steps // 20, 1)])
        + f"; first 5 mean {first:.4f} -> final {res.final_loss:.4f} "
        f"(data entropy floor {data.optimal_nll():.4f}); "
        f"{res.tokens_per_s:.0f} tokens/s; launches {counts}")
    if not res.final_loss <= first - drop:
        fail(f"train loop: final loss {res.final_loss:.4f} is not {drop} "
             f"below the first steps' {first:.4f}")
    if counts["moe_gemm"] != args.steps * train_small_cli.PRESETS[
            args.preset].num_layers or sum(counts.values()) != \
            counts["moe_gemm"]:
        fail(f"train loop: launches {counts}")
    model = build_model(train_small_cli.PRESETS[args.preset],
                        dtype=torch.float32, device=TRAIN_DEVICE)
    like = {"params": model.init(generator_for(model.device, 1))}
    back, step = load_checkpoint(ckpt, like)
    stored = np.load(os.path.join(ckpt, "arrays.npz"))
    for i, leaf in enumerate(tree_leaves(back)):
        if not torch.equal(leaf.cpu(), torch.from_numpy(stored[f"leaf_{i}"])):
            fail(f"train loop: checkpoint leaf {i} does not load back bit "
                 "for bit")
    with torch.no_grad():
        again = float(model.loss(back["params"], torch.from_numpy(
            data.sample_batch(args.steps - 1)).to(model.device)))
    print(f"[train loop] checkpoint step {step}: {len(stored.files)} leaves "
          f"load back bit for bit; its loss on the last batch {again:.4f}")
    if step != args.steps or not abs(again - res.final_loss) < 0.5:
        fail(f"train loop: the checkpoint (step {step}, loss {again:.4f}) "
             "is not the trained model")
    return counts, dict(preset=args.preset, steps=args.steps, drop=drop,
                        first5=first, final_loss=res.final_loss,
                        entropy_floor=data.optimal_nll(),
                        tokens_per_s=res.tokens_per_s,
                        ckpt_loss=again,
                        losses=res.losses[::max(args.steps // 20, 1)])


#: the sharded train step on the card (``build(..., mesh=...)``, DEP
#: under autograd): (i) at world size 1 over NCCL, bf16, TRAIN_LAYERS at
#: full width, against the capacity path's step on the same weights;
#: every gradient leaf's relative L2 (and the loss's relative error)
#: within the limit, and the control (the reverse exchange's backward
#: with two experts' rows swapped) beyond it. At one rank the two paths
#: dispatch to the same capacity and run the same kernels on the same
#: buffers: the limit is set from the sound readings (PERF.md)
TRAIN_DEP_TOL = {torch.bfloat16: 1e-3, torch.float32: TRAIN_SMALL_TOL}
#: (ii) two gloo ranks sharing the card, a (1, 2) mesh, f32: their depth
#: (f32 weights, gradients and the one-rank reference on rank 0 beside
#: the two ranks' shards) and the batch
TRAIN_EP_LAYERS = 2
TRAIN_EP_BATCH = 2
TRAIN_EP_TIMEOUT_S = 600


def rel_l2_dev(got, want) -> float:
    """``rel_l2`` computed where the tensors live."""
    g, w = got.detach().float(), want.detach().float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def swapped_reverse_exchange(orig):
    """A control: the reverse exchange, then the rows of the first two
    experts of its result swapped (expert dim 0 of A2E's [E_pad, c, M],
    1 of E2A's [mo, E_loc, c, M])."""
    def control(grad, shape, group):
        out = orig(grad, shape, group)
        dim = 0 if len(shape) == 3 else 1
        idx = torch.arange(out.shape[dim], device=out.device)
        idx[0], idx[1] = 1, 0
        return out.index_select(dim, idx)
    return control


class BackwardCalls:
    """While entered, counts the expert GEMM Function's backward calls
    (``moe_gemm_backward``, the eight ``torch.bmm``: no kernel of the
    repo, so no launch count of its own)."""

    def __enter__(self):
        self.calls = 0
        self._wrapped = gemm_ops.moe_gemm_backward

        def counted(*args, **kw):
            self.calls += 1
            return self._wrapped(*args, **kw)
        gemm_ops.moe_gemm_backward = counted
        return self

    def __exit__(self, *exc):
        gemm_ops.moe_gemm_backward = self._wrapped


def grad_errors(got, want) -> dict:
    return {n: rel_l2_dev(a, b) for (n, a), (_, b) in
            zip(named_leaves(got), named_leaves(want))}


def train_sharded_one() -> tuple:
    """(i) of the sharded train step: ``build`` on a (1, 1)
    ``make_host_mesh`` over an NCCL group of one rank (gloo on the CPU),
    qwen2-moe-a2.7b cut to ``TRAIN_LAYERS`` at full width, bf16, capacity
    factor E / top_k (nothing dropped), remat as ``build`` sets it for a
    train shape. The parameters laid out as DTensors by the bundle's
    specs; ``sharded_loss_and_grads`` against ``loss_and_grads`` of the
    capacity path on the same weights and batch: the loss and every
    gradient leaf within ``TRAIN_DEP_TOL``, beside the control
    (``swapped_reverse_exchange``), which must exceed it; every leaf
    finite and non-zero; the expert GEMM 2 x TRAIN_LAYERS launches and
    TRAIN_LAYERS backward calls a backward pass. Then two steps of the
    bundle's ``step_fn`` (AdamW, bf16 states, in place on the shards),
    timed. Returns (launches of the sharded steps, the report row)."""
    t0 = time.perf_counter()
    dt = torch.bfloat16
    DepGroups.single("nccl" if TRAIN_DEVICE == "cuda" else "gloo")
    mesh = make_host_mesh(model=1, device_type=TRAIN_DEVICE)
    cfg = no_drop(dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                                      num_layers=TRAIN_LAYERS))
    shape = ShapeConfig("train_card", TRAIN_SEQ, TRAIN_BATCH, "train")
    b = build_bundle(cfg, shape, mesh=mesh, dtype=dt,
                     device=TRAIN_DEVICE)
    if b.model.ctx.moe_impl != "dep" or b.accum_steps != 1:
        fail(f"train sharded: bundle {b.model.ctx.moe_impl} accum "
             f"{b.accum_steps}")
    full = b.model.init(generator_for(b.model.device, 0))
    params = distribute_params(full, b.placements[0], mesh)
    del full
    local = tree_unflatten(params, [p.to_local() for p in
                                    tree_leaves(params)])
    cap = build_model(cfg, ctx=ExecutionContext(remat=True), dtype=dt,
                      device=TRAIN_DEVICE)
    toks = torch.from_numpy(MarkovTextDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0)).sample_batch(0)).to(cap.device)
    l_cap, g_cap = loss_and_grads(cap, local, toks)
    L = TRAIN_LAYERS
    before = kernel_lib.launch_counts()
    with GemmWidths() as widths, BackwardCalls() as bwd:
        l_dep, g_dep = sharded_loss_and_grads(b.model, params, mesh,
                                              shard_batch(toks, mesh))
    expect_launches("train sharded backward pass", launch_delta(before),
                    {"moe_gemm": 2 * L})
    if bwd.calls != L:
        fail(f"train sharded: {bwd.calls} expert GEMM backward calls, "
             f"want {L}")
    g_dep = tree_unflatten(params, [g.to_local() for g in
                                    tree_leaves(g_dep)])
    check_gradients(g_dep)
    limit = TRAIN_DEP_TOL[dt]
    loss_err = abs(float(l_dep) - float(l_cap)) / abs(float(l_cap))
    errs = grad_errors(g_dep, g_cap)
    worst = max(errs, key=errs.get)
    del g_dep
    orig = dep_lib.reverse_exchange
    dep_lib.reverse_exchange = swapped_reverse_exchange(orig)
    try:
        _, g_ctrl = sharded_loss_and_grads(b.model, params, mesh,
                                           shard_batch(toks, mesh))
    finally:
        dep_lib.reverse_exchange = orig
    ctrl = grad_errors(tree_unflatten(params, [g.to_local() for g in
                                               tree_leaves(g_ctrl)]), g_cap)
    ctrl_worst = max(ctrl.values())
    del g_ctrl, g_cap
    print(f"[train sharded] {cfg.name} {L} of 24 layers, bf16, a "
          f"{tuple(axis for axis in mesh.mesh_dim_names)} mesh of "
          f"{tuple(mesh.shape)} over {dist_backend()}: DEP loss "
          f"{float(l_dep):.6f}, capacity path {float(l_cap):.6f} "
          f"(relative {loss_err:.2e}); {len(errs)} gradient leaves, worst "
          f"relative L2 {errs[worst]:.3e} ({worst}); limit {limit}; the "
          f"control (reverse exchange with experts 0 and 1 swapped) worst "
          f"{ctrl_worst:.3e}; expert GEMM {2 * L} launches and {L} "
          f"backward calls a backward pass")
    if loss_err > limit or errs[worst] > limit:
        fail(f"train sharded: the DEP step disagrees with the capacity "
             f"path's (loss {loss_err:.2e}, {worst} {errs[worst]:.2e})")
    if ctrl_worst <= limit:
        fail("train sharded: the swapped-exchange control is within the "
             "limit")
    check_dep_widths({cfg.moe.num_experts: local["layers"][0]["moe"]
                      ["experts"]}, widths.shapes,
                     torch.device(TRAIN_DEVICE), "train sharded")
    opt_cfg = AdamWConfig(state_dtype=torch.bfloat16)
    state = init_opt_state(params, opt_cfg)
    losses, norms, step_s = [], [], []
    before = kernel_lib.launch_counts()
    for s in range(2):
        sync()
        t = time.perf_counter()
        params, state, m = b.step_fn(params, state, toks)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        sync()
        step_s.append(time.perf_counter() - t)
    counts = launch_delta(before)
    expect_launches("train sharded steps", counts, {"moe_gemm": 4 * L})
    if not all(np.isfinite(losses + norms)):
        fail(f"train sharded: losses {losses} grad norms {norms}")
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if TRAIN_DEVICE == "cuda" else 0.0)
    row = dict(config=f"{cfg.name} {L} of 24 layers", loss_rel=loss_err,
               worst_grad_rel_l2=errs[worst], worst_leaf=worst,
               control_worst=ctrl_worst, losses=losses, grad_norms=norms,
               step_ms=[x * 1e3 for x in step_s], peak_gb=peak)
    print(f"[train sharded] two steps of the bundle's step_fn: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}, grad norms "
          f"{', '.join(f'{v:.3f}' for v in norms)}, "
          f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms; peak "
          f"{peak:.2f} GB allocated")
    del params, state, local, cap, b, m
    torch.distributed.destroy_process_group()
    sync()
    if TRAIN_DEVICE == "cuda":
        torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t0
    return counts, row


def dist_backend() -> str:
    return str(torch.distributed.get_backend())


def split_aux_capacity(orig, parts: int):
    """The one-rank reference of an expert group of ``parts`` ranks in
    sequence mode: the capacity path's output on every token, and its aux
    loss as the DEP layers' device mean, the mean of the aux of each
    rank's slice of the sequence (each slice routed on its own)."""
    def apply(params, x, mcfg, num_experts_padded=0, **kw):
        out = orig(params, x, mcfg, num_experts_padded, **kw)
        M = x.shape[-1]
        aux = torch.stack([moe_lib.load_balance_loss(moe_lib.route_topk(
            params["router"], part.reshape(-1, M), mcfg,
            num_experts_padded), mcfg) for part in x.chunk(parts, dim=1)])
        return (out[0], aux.mean()) + tuple(out[2:])
    return apply


def train_rank_work(rank: int, device) -> dict:
    """One rank of (ii): a (1, 2) mesh over the two gloo ranks, f32,
    ``TRAIN_EP_LAYERS`` at full width, capacity factor E / top_k. Both
    ranks draw the whole model from seed 0 and keep their shards; rank 0
    also keeps the whole tree for the one-rank reference (the capacity
    path with the aux as the two ranks' device mean,
    ``split_aux_capacity``). The two-rank loss and every gradient leaf
    (gathered whole, ``gather_shards``) within ``TRAIN_DEP_TOL`` f32 of
    the reference's, beside the control (the reverse exchange skipped),
    which must exceed it; then one step of the bundle's ``step_fn``."""
    t0 = time.perf_counter()
    mesh = make_host_mesh(model=2, device_type=device.type)
    cfg = no_drop(dataclasses.replace(get_config("qwen2-moe-a2.7b"),
                                      num_layers=TRAIN_EP_LAYERS))
    shape = ShapeConfig("train_ep", TRAIN_SEQ, TRAIN_EP_BATCH, "train")
    b = build_bundle(cfg, shape, mesh=mesh, dtype=torch.float32,
                     device=device)
    full = b.model.init(generator_for(device, 0))
    params = distribute_params(full, b.placements[0], mesh)
    toks = torch.from_numpy(MarkovTextDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_EP_BATCH, seed=0)).sample_batch(0)).to(device)
    mine = shard_batch(toks, mesh)
    out = {"layers": TRAIN_EP_LAYERS}
    if rank == 0:
        cap = build_model(cfg, ctx=ExecutionContext(remat=True),
                          dtype=torch.float32, device=device)
        orig = moe_lib.moe_apply_capacity
        moe_lib.moe_apply_capacity = split_aux_capacity(orig, 2)
        try:
            l_ref, g_ref = loss_and_grads(cap, full, toks)
        finally:
            moe_lib.moe_apply_capacity = orig
        ref_leaves = [g for _, g in named_leaves(g_ref)]
    del full

    def compare_grads(what):
        loss, grads = sharded_loss_and_grads(b.model, params, mesh, mine)
        errs = {}
        names = [n for n, _ in named_leaves(grads)]
        for i, (n, g) in enumerate(named_leaves(grads)):
            whole = gather_shards(g.to_local(), mesh, g.placements)
            if not bool(torch.isfinite(whole).all()) or \
                    float(whole.abs().amax()) == 0:
                fail(f"train ranks: {what} gradient {n} non-finite or zero")
            if rank == 0:
                errs[n] = rel_l2_dev(whole, ref_leaves[i])
            del whole
        del grads
        if rank != 0:
            return float(loss), {}
        return float(loss), errs

    loss, errs = compare_grads("sound")
    orig = dep_lib.reverse_exchange
    dep_lib.reverse_exchange = lambda grad, shp, group: grad.reshape(shp)
    try:
        _, ctrl = compare_grads("control")
    finally:
        dep_lib.reverse_exchange = orig
    if rank == 0:
        limit = TRAIN_DEP_TOL[torch.float32]
        loss_err = abs(loss - float(l_ref)) / abs(float(l_ref))
        worst = max(errs, key=errs.get)
        ctrl_worst = max(ctrl.values())
        out.update(loss=loss, ref_loss=float(l_ref), loss_rel=loss_err,
                   worst_grad_rel_l2=errs[worst], worst_leaf=worst,
                   control_worst=ctrl_worst)
        print(f"[train ranks] {cfg.name} {TRAIN_EP_LAYERS} of 24 layers at "
              f"full width, f32, a (1, 2) mesh of two gloo ranks on one "
              f"card, {TRAIN_EP_BATCH} x {TRAIN_SEQ} tokens: loss "
              f"{loss:.6f} against the one-rank reference's "
              f"{float(l_ref):.6f} (relative {loss_err:.2e}); {len(errs)} "
              f"gradient leaves, worst relative L2 {errs[worst]:.3e} "
              f"({worst}); limit {limit}; the control (reverse exchange "
              f"skipped) worst {ctrl_worst:.3e}", flush=True)
        if loss_err > limit or errs[worst] > limit:
            fail(f"train ranks: the two-rank step disagrees with one rank "
                 f"(loss {loss_err:.2e}, {worst} {errs[worst]:.2e})")
        if ctrl_worst <= limit:
            fail("train ranks: the skipped-exchange control is within the "
                 "limit")
        del g_ref, ref_leaves, cap
    state = init_opt_state(params, AdamWConfig(state_dtype=torch.bfloat16))
    t = time.perf_counter()
    params, state, m = b.step_fn(params, state, toks)
    if device.type == "cuda":
        torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t) * 1e3
    out["step_loss"] = float(m["loss"])
    out["step_grad_norm"] = float(m["grad_norm"])
    if not (np.isfinite(out["step_loss"]) and
            np.isfinite(out["step_grad_norm"])):
        fail(f"train ranks: step loss {out['step_loss']}")
    out["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9
                      if device.type == "cuda" else 0.0)
    out["wall_s"] = time.perf_counter() - t0
    return out


def train_rank(rank: int, store_dir: str, results, setup=None):
    """A spawned rank process of (ii): joins the gloo group over the
    ``file://`` store in ``store_dir`` and runs ``train_rank_work``."""
    if setup is not None:
        setup()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(TRAIN_DEVICE, 0) if TRAIN_DEVICE == "cuda" \
        else torch.device(TRAIN_DEVICE)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store_dir}/store", rank=rank,
        world_size=2)
    try:
        results.put((rank, train_rank_work(rank, device)))
    finally:
        torch.distributed.destroy_process_group()


def train_sharded_ranks(setup=None) -> dict:
    """(ii) of the sharded train step: two spawned processes share the
    card over gloo (NCCL refuses two ranks on one card), as the ep phase
    runs them; ``train_rank_work`` in each. Returns rank 0's row."""
    import multiprocessing
    import queue
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got = {}
    with tempfile.TemporaryDirectory(prefix="chip-smoke-train-") as d:
        procs = [ctx.Process(target=train_rank, args=(r, d, results, setup))
                 for r in range(2)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + TRAIN_EP_TIMEOUT_S
        while len(got) < 2:
            try:
                r, res = results.get(timeout=5)
                got[r] = res
            except queue.Empty:
                if any(p.exitcode for p in procs) or \
                        time.monotonic() > deadline:
                    for p in procs:
                        p.kill()
                        p.join()
                    fail(f"train ranks: a rank failed or timed out (exit "
                         f"codes {[p.exitcode for p in procs]})")
        for p in procs:
            p.join(timeout=120)
            if p.exitcode != 0:
                fail(f"train ranks: a rank exited with {p.exitcode}")
    if got[0]["step_loss"] != got[1]["step_loss"]:
        fail(f"train ranks: the ranks' losses differ "
             f"({got[0]['step_loss']} / {got[1]['step_loss']})")
    print(f"[train ranks] one step of the bundle's step_fn on both ranks: "
          f"loss {got[0]['step_loss']:.6f}, grad norm "
          f"{got[0]['step_grad_norm']:.4f}, {got[0]['step_ms']:.1f} / "
          f"{got[1]['step_ms']:.1f} ms; peak {got[0]['peak_gb']:.2f} / "
          f"{got[1]['peak_gb']:.2f} GB allocated; rank walls "
          f"{got[0]['wall_s']:.1f} / {got[1]['wall_s']:.1f} s")
    return got[0]


def phase_train(setup=None) -> tuple:
    """Training on the card: the expert GEMM's Function
    (``check_train_gemm``), qwen2-moe-a2.7b at full width
    (``train_full``), the sharded train step at one rank
    (``train_sharded_one``) and on two ranks (``train_sharded_ranks``;
    ``setup`` runs first in each, the CPU rehearsal's patches), the smoke
    step against the CPU (``train_small``) and the train loop through its
    entry point (``train_loop``). Returns ({path: launches}, the expert
    GEMM's train row, the summary)."""
    gemm = check_train_gemm()
    counts, full = train_full()
    sharded_counts, sharded = train_sharded_one()
    ranks = train_sharded_ranks(setup)
    small = train_small()
    paths, loops = {"train": counts, "train sharded": sharded_counts}, []
    os.makedirs(os.path.join(ROOT, ".repro-train"), exist_ok=True)
    for argv, drop in TRAIN_LOOP_RUNS:
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, ".repro-train")) as ckpt:
            loop_counts, loop = train_loop(argv, drop, ckpt)
        paths[f"train_loop {loop['preset']}"] = loop_counts
        loops.append(loop)
    summary = dict(full=full, sharded=sharded, ranks=ranks, small=small,
                   loops=loops)
    print("[train summary] " + json.dumps(summary))
    return paths, gemm, summary


# ---------------------------------------------------------------------------
# phase 8b: the recurrent families trained through the scans' backwards
# ---------------------------------------------------------------------------

#: (arch, layers, scan) of the recurrent train path: full width, depth cut
#: for memory and time. xlstm-1.3b at one 7:1 pattern of its 48 layers
#: (7 mLSTM + 1 sLSTM); recurrentgemma-9b at two (rec, rec, attn)
#: patterns of its 38 (bf16 weights, gradients and two AdamW states, 8
#: bytes a parameter: all 38 layers would exceed 80 GB)
TRAIN_RECURRENT = (("xlstm-1.3b", 8, "mlstm_scan"),
                   ("recurrentgemma-9b", 6, "rg_lru_scan"))
TRAIN_RECURRENT_STEPS = 3


def scan_operands(cfg, scan: str, gen):
    """The scan's f32 operands at the train path's shape (``TRAIN_BATCH``
    x ``TRAIN_SEQ``), the incoming state fresh as the model makes it, and
    a gradient for h: (forward operands, dh)."""
    B, S = TRAIN_BATCH, TRAIN_SEQ
    if scan == "mlstm_scan":
        H = cfg.num_heads
        D = 2 * cfg.d_model // H
        args = mlstm_inputs(gen, B, H, S, D, fresh=True)
        return args, randn(gen, (B, H, S, D), torch.float32)
    W = cfg.recurrent.lru_width or cfg.d_model
    a = 0.8 + 0.199 * torch.rand((B, S, W), generator=gen, device="cuda")
    return ((a, randn(gen, (B, S, W), torch.float32, 0.1),
             torch.zeros((B, W), device="cuda")),
            randn(gen, (B, S, W), torch.float32))


def time_scan_function(cfg, scan: str, gen) -> dict:
    """The scan's autograd Function at the train shape, as the train path
    calls it (the projections' outputs require a gradient, the fresh
    state does not, only h is used): the forward (``Function.apply``
    under grad mode) and the backward (``torch.autograd.grad`` of h,
    which gives the Function zeros for its unused outputs) timed apart
    by CUDA events, each beside its bound from its ``*_work`` formula;
    and the backward wrapper alone on the same operands, so the
    Function's own share shows."""
    args, dh = scan_operands(cfg, scan, gen)
    if scan == "mlstm_scan":
        fn, wrapper = MLSTMScanFunction, mlstm_scan_backward
        leaves = args[:5]
        f_b = work_bound(mlstm_scan_work, *args)
    else:
        fn, wrapper = RGLRUScanFunction, rg_lru_scan_backward
        leaves = args[:2]
        f_b = work_bound(rg_lru_scan_work, *args, dtype=torch.float32)
    for t in leaves:
        t.requires_grad_(True)

    def fwd():
        with torch.enable_grad():
            return fn.apply(*args)
    out = fwd()
    h = out[0]
    plain = [t.detach() for t in args]
    zeros = [torch.zeros_like(t) for t in out[1:]]
    if scan == "mlstm_scan":
        wargs = (*plain, h.detach(), dh, *zeros)
        b_b = mlstm_bwd_bound(*wargs)
    else:
        wargs = (plain[0], plain[2], h.detach(), dh, *zeros)
        b_b = work_bound(rg_lru_scan_backward_work, *wargs)
    row = dict(shape=" x ".join(str(d) for d in args[0].shape) + " f32",
               forward_ms=time_ms(fwd, iters=5), forward_bound_ms=f_b[0],
               forward_bound_by=f_b[1],
               backward_ms=time_ms(lambda: torch.autograd.grad(
                   h, leaves, dh, retain_graph=True), iters=5),
               backward_wrapper_ms=time_ms(lambda: wrapper(*wargs),
                                           iters=5),
               backward_bound_ms=b_b[0], backward_bound_by=b_b[1])
    old = (f"; {STEPWISE_LABEL}: {STEPWISE_MLSTM_BWD['function_ms']} ms "
           "through the Function" if scan == "mlstm_scan" else "")
    print(f"[train_recurrent] {fn.__name__} at {row['shape']} on {card()}:"
          f" forward {row['forward_ms']:.3f} ms (bound {f_b[0]:.3f}, "
          f"{f_b[1]}), backward {row['backward_ms']:.3f} ms (the wrapper "
          f"alone {row['backward_wrapper_ms']:.3f}; bound {b_b[0]:.3f}, "
          f"{b_b[1]}) (CUDA events){old}")
    del out, h, args, leaves, plain, zeros, wargs
    return row


def train_recurrent_one(arch: str, layers: int, scan: str) -> tuple:
    """``arch`` at full width cut to ``layers``, bf16 weights from seed 0,
    ``TRAIN_RECURRENT_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ``
    Markov tokens with the default AdamW (bf16 states), under
    ``attn_impl="xla"``: step 1 ``loss_and_grads`` with every gradient
    leaf checked (finite, not all zero), then ``make_train_step``; every
    step the loss and grad norm finite and the scan's forward and
    backward each launched once per scan layer, no other kernel. Then one
    step counted on the card and on a meta twin (equal counts) and timed
    beside its least time, and the scan's Function timed at the path's
    shape. Returns (launches over the steps, the row)."""
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg, dtype=torch.bfloat16, device=TRAIN_DEVICE)
    params = model.init(generator_for(model.device, 0))
    n_params = sum(t.numel() for t in _leaves(params))
    kind = "mlstm" if scan == "mlstm_scan" else "rec"
    n_scan = model.kinds.count(kind)
    opt_cfg = AdamWConfig(state_dtype=torch.bfloat16)
    state = init_opt_state(params, opt_cfg)
    step_fn = make_train_step(model, opt_cfg)
    data = MarkovTextDataset(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
        batch_size=TRAIN_BATCH, seed=0))
    batches = [torch.from_numpy(data.sample_batch(s)).to(model.device)
               for s in range(TRAIN_RECURRENT_STEPS + 1)]
    want = {scan: n_scan, f"{scan}_backward": n_scan}
    total = {k: 0 for k in kernel_lib.launch_counts()}
    losses, norms, step_s = [], [], []
    if TRAIN_DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for s in range(TRAIN_RECURRENT_STEPS):
        before = kernel_lib.launch_counts()
        sync()
        t = time.perf_counter()
        if s == 0:
            loss, grads = loss_and_grads(model, params, batches[s])
            check_gradients(grads)
            params, state, gnorm = apply_updates(params, grads, state,
                                                 opt_cfg)
            del grads
            metrics = {"loss": loss, "grad_norm": gnorm}
        else:
            params, state, metrics = step_fn(params, state, batches[s])
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        sync()
        step_s.append(time.perf_counter() - t)
        delta = launch_delta(before)
        expect_launches(f"train_recurrent {arch} step {s}", delta, want)
        for k, v in delta.items():
            total[k] += v
        if not (np.isfinite(losses[-1]) and np.isfinite(norms[-1])):
            fail(f"train_recurrent {arch}: step {s} loss {losses[-1]} grad "
                 f"norm {norms[-1]}")
    peak = (torch.cuda.max_memory_allocated() / 1e9
            if TRAIN_DEVICE == "cuda" else 0.0)

    batch = batches[TRAIN_RECURRENT_STEPS]

    def run():
        return step_fn(params, state, batch)[2]["loss"]
    on_card, _ = count_step(run)
    twin = build_model(cfg, dtype=torch.bfloat16, device="meta")
    # the card's leaves as they are (RG-LRU's lam stays f32), not
    # abstract_params' (the reference's dry run casts every leaf)
    mparams = tree_map(lambda t: torch.empty_like(t, device="meta"), params)
    mstate = init_opt_state(mparams, opt_cfg)
    mbatch = meta(tuple(batch.shape), batch.dtype)
    on_meta, _ = count_step(lambda: make_train_step(twin, opt_cfg)(
        mparams, mstate, mbatch))
    label = f"{arch} train step {TRAIN_BATCH} x {TRAIN_SEQ}, {layers} layers"
    same_counts(label, on_card, on_meta)
    roof = roofline_share(label, on_card.counts,
                          time_ms(run, iters=2, warmup=0))
    step_ms = float(np.median(step_s[1:])) * 1e3
    row = dict(config=f"{cfg.name} {layers} of {get_config(arch).num_layers}"
               f" layers ({n_scan} {kind})", params=n_params,
               batch=f"{TRAIN_BATCH} x {TRAIN_SEQ}", losses=losses,
               grad_norms=norms, step_ms=step_ms,
               step_ms_all=[x * 1e3 for x in step_s],
               tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / step_ms * 1e3,
               peak_gb=peak, launches_per_step=want, roofline=roof)
    print(f"[train_recurrent] {row['config']} ({n_params / 1e9:.3f} B "
          f"params, bf16, AdamW bf16 states) on {card()}: losses "
          + ", ".join(f"{v:.4f}" for v in losses)
          + "; grad norms " + ", ".join(f"{v:.3f}" for v in norms)
          + f"; step {step_ms:.1f} ms (median of steps 2-"
          f"{TRAIN_RECURRENT_STEPS}; all "
          f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)}), "
          f"{row['tokens_per_s']:.0f} tokens/s, peak {peak:.2f} GB; "
          f"{scan} {n_scan} forward and {n_scan} backward launches a step"
          + (f" ({STEPWISE_LABEL}: "
             f"{STEPWISE_MLSTM_BWD['xlstm_step_ms'][0]}-"
             f"{STEPWISE_MLSTM_BWD['xlstm_step_ms'][1]} ms a step, peak "
             f"{STEPWISE_MLSTM_BWD['xlstm_peak_gb']:.2f} GB)"
             if arch == "xlstm-1.3b" else ""))
    del model, twin, params, state, batches, metrics, loss, mparams, mstate
    sync()
    if TRAIN_DEVICE == "cuda":
        torch.cuda.empty_cache()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        row["function"] = time_scan_function(cfg, scan, gen)
        torch.cuda.empty_cache()
    row["wall_s"] = time.perf_counter() - t0
    return total, row


def phase_train_recurrent() -> dict:
    """xlstm-1.3b and recurrentgemma-9b trained on the card through the
    scans' autograd Functions (``train_recurrent_one``). Returns {path:
    launches}."""
    counts, rows = {}, {}
    for arch, layers, scan in TRAIN_RECURRENT:
        counts[f"train_recurrent {arch}"], rows[arch] = train_recurrent_one(
            arch, layers, scan)
    print("[train_recurrent summary] " + json.dumps(rows))
    return counts


#: the device-side names of the repo's CUDA kernels (src/repro_torch/csrc)
OWN_KERNELS = ("decode_attention_split_kernel",
               "decode_attention_combine_kernel", "moe_gemm_",
               "flash_attention_", "mlstm_scan_kernel",
               "mlstm_chunk_prep_kernel", "mlstm_chunk_scan_kernel",
               "rg_lru_scan_kernel", "rg_lru_scan_short_kernel")


#: wrapper launch counter -> (device event name filter, events per call)
TRACED = {"decode_attention": ("decode_attention_", 2),
          "decode_attention_paged": ("decode_attention_", 2),
          "moe_gemm": ("moe_gemm_", 2),
          "flash_attention": ("flash_attention_", 1),
          "rg_lru_scan": ("rg_lru_scan", 1)}


def traced_launches(prof, before, after, names=None) -> dict:
    """For the repo's kernels: {name filter: [device events in the trace,
    events the wrappers' launches between ``before`` and ``after`` make]}.
    The profiler can drop the tail of a trace; this shows how much of
    the kernels a profile's numbers hold."""
    want = {}
    for name, (pattern, per) in TRACED.items():
        if names is None or name in names:
            want[pattern] = want.get(pattern, 0) + per * (after[name]
                                                         - before[name])
    events = device_events(prof)
    got = {p: sum(p in e.name for e in events) for p in want}
    return {p: [got[p], want[p]] for p in want if want[p] or got[p]}


def profile_decode(eng, rng, cfg, path: str, steps: int = 3) -> dict:
    """Where a steady decode step's time goes: the wall time of ``steps``
    plain decode steps, then the same number under torch.profiler for the
    device time by kernel (the profiler's device events include the
    kernels a graph replay launches), the expert GEMM's and NCCL's share
    of it; the idle share is 1 - the time some kernel runs (the union of
    the kernels' spans: the DEP path's comm stream overlaps the compute
    stream) / plain wall time. Also counts the host's
    ``cudaGraphLaunch`` and ``cudaLaunchKernel`` calls. Returns the
    printed row."""
    for _ in range(eng.num_slots):
        eng.submit(Request(prompt=list(rng.randint(0, cfg.vocab_size,
                                                   size=300)),
                           max_new_tokens=2 * steps + 2))
    eng.step()                      # admit + prefill + first decode
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    before = kernel_lib.launch_counts()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
    traced = traced_launches(prof, before, kernel_lib.launch_counts())
    eng.run()
    per_kernel = {}
    for e in device_events(prof):
        us, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_kernel.values()) / 1e3 / steps
    if busy_ms <= 0:
        fail(f"profile {path}: the profiler recorded no kernel on the card")
    host_calls = {name: sum(e.name == name for e in prof.events()) / steps
                  for name in ("cudaGraphLaunch", "cudaLaunchKernel",
                               "cudaMemcpyAsync", "cudaStreamSynchronize")}
    # the card's idle time inside the window: short gaps between device
    # ops (launch latency) apart from long ones (the host between steps)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in device_events(prof))
    gaps = [b[0] - a[1] for a, b in zip(spans, spans[1:])]
    covered, end = 0.0, None
    for s, e in spans:               # the union of the kernels' spans
        if end is None or s > end:
            covered, end = covered + e - s, e
        elif e > end:
            covered, end = covered + e - end, e
    covered_ms = covered / 1e3 / steps
    row = dict(wall_ms=wall_ms, kernel_ms=busy_ms,
               device_ops=sum(n for _, n in per_kernel.values()) // steps,
               moe_gemm_ms=sum(us for name, (us, _) in per_kernel.items()
                               if "moe_gemm_" in name) / 1e3 / steps,
               nccl_kernel_ms=sum(us for name, (us, _) in per_kernel.items()
                                  if "nccl" in name.lower()) / 1e3 / steps,
               dtod_ms=per_kernel.get("Memcpy DtoD (Device -> Device)",
                                      (0.0, 0))[0] / 1e3 / steps,
               dtod=per_kernel.get("Memcpy DtoD (Device -> Device)",
                                   (0.0, 0))[1] // steps,
               busy_ms=covered_ms, idle=max(0.0, 1 - covered_ms / wall_ms),
               **host_calls,
               gaps_under_50us_ms=sum(g for g in gaps if 0 < g < 50)
               / 1e3 / steps,
               gaps_over_50us_ms=sum(g for g in gaps if g >= 50)
               / 1e3 / steps)
    print(f"[profile {path}] decode step, 8 slots at ~300-token contexts, "
          f"graph {'on' if eng.decode_graph else 'off'}: wall "
          f"{wall_ms:.2f} ms/step, kernels {busy_ms:.2f} ms/step "
          f"({row['device_ops']} device ops; expert GEMM "
          f"{row['moe_gemm_ms']:.2f}, NCCL kernels "
          f"{row['nccl_kernel_ms']:.2f}, {row['dtod']} device-to-device "
          f"copies {row['dtod_ms']:.2f}), device "
          f"idle share {row['idle']:.3f}; per step "
          f"{host_calls['cudaGraphLaunch']:g} "
          f"cudaGraphLaunch, {host_calls['cudaLaunchKernel']:g} "
          f"cudaLaunchKernel; gaps between device ops "
          f"{row['gaps_under_50us_ms']:.2f} ms/step under 50 us, "
          f"{row['gaps_over_50us_ms']:.2f} over " + json.dumps(row))
    print(f"[profile {path}] the repo's kernels in the trace / launched: "
          + json.dumps(traced))
    # the ten largest, then the repo's own kernels that fall below them
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, n)) in enumerate(ranked):
        if i < 10 or any(k in name for k in OWN_KERNELS):
            print(f"  {us / 1e3 / steps:8.3f} ms/step {n // steps:5d}/step  "
                  f"{name[:80]}")
    # the host side of the same window: operators and CUDA runtime calls
    # by self CPU time (profiled, so each is inflated by the tracing)
    host = sorted((e for e in prof.key_averages()
                   if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    for e in host:
        print(f"  host {e.self_cpu_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count // steps:5d}/step  {e.key[:60]}")
    return row


def profile_prefill(eng, prompts, path: str, calls: int = 1) -> None:
    """Where one batched prefill admission's time goes: ``prompts`` (of
    one length, so one bucket: one call, or ``calls`` when the engine's
    plan chunks the group) admitted together, three times (each drained
    by one decode step): a warm-up, one timed by the engine's prefill
    clock, one under torch.profiler for the device time by kernel. Idle
    share = 1 - kernel time / the calls' wall time."""
    def admit(prof=None) -> float:
        for p in prompts:
            eng.submit(Request(prompt=list(p), max_new_tokens=1))
        torch.cuda.synchronize()
        s0, n0 = eng.stats.prefill_s, eng.stats.prefill_calls
        if prof is None:
            eng._admit()
        else:
            with prof:
                eng._admit()
                torch.cuda.synchronize()
        if eng.stats.prefill_calls != n0 + calls:
            fail(f"prefill {path}: {eng.stats.prefill_calls - n0} prefill "
                 f"calls, expected {calls}")
        ms = (eng.stats.prefill_s - s0) * 1e3
        eng.run()
        return ms

    admit()
    wall_ms = admit()
    before = kernel_lib.launch_counts()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    admit(prof)
    # the counts move on with the drain after the admission, which
    # launches no prefill kernel (flash, the chunked expert GEMM's r1·r2)
    traced = traced_launches(prof, before, kernel_lib.launch_counts(),
                             names=("flash_attention",))
    per_kernel = {}
    for e in device_events(prof):
        us, n = per_kernel.get(e.name, (0.0, 0))
        per_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    busy_ms = sum(us for us, _ in per_kernel.values()) / 1e3
    if busy_ms <= 0:
        fail(f"prefill {path}: the profiler recorded no kernel on the card")
    flash_ms = sum(us for name, (us, _) in per_kernel.items()
                   if "flash_attention_" in name) / 1e3
    gemm_ms = sum(us for name, (us, _) in per_kernel.items()
                  if "moe_gemm_" in name) / 1e3
    print(f"[prefill {path}] {calls} prefill call(s) of {len(prompts)} x "
          f"{len(prompts[0])} tokens in all: wall {wall_ms:.2f} ms, kernels "
          f"{busy_ms:.2f} ms ({sum(n for _, n in per_kernel.values())} "
          f"launches), device idle share {max(0.0, 1 - busy_ms / wall_ms):.3f};"
          f" flash {flash_ms:.3f} ms ({flash_ms / busy_ms:.1%} of kernel "
          f"time), expert GEMM {gemm_ms:.3f} ms")
    print(f"[prefill {path}] flash kernels in the trace / launched: "
          + json.dumps(traced))
    own = {k: (sum(us for name, (us, _) in per_kernel.items() if k in name),
               sum(n for name, (_, n) in per_kernel.items() if k in name))
           for k in OWN_KERNELS}
    print(f"[prefill {path}] the repo's kernels: " + ", ".join(
        f"{k} {us / 1e3:.3f} ms in {n}" for k, (us, n) in own.items() if n))
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])
    for i, (name, (us, n)) in enumerate(ranked):
        if i < 10 or any(k in name for k in OWN_KERNELS):
            print(f"  {us / 1e3:8.3f} ms/call {n:5d}/call  {name[:80]}")


def check_bounds(name: str, entry: dict) -> None:
    """Fail a kernel whose device time, at any shape of its entry, reads
    below the bound the entry gives for that shape: the card cannot go
    faster, so the profiler dropped some of its work."""
    for key in ("device_ms", "cold_device_ms"):
        if key in entry and "bound_ms" in entry \
                and entry[key] < entry["bound_ms"]:
            fail(f"{name}: {key} {entry[key]:.4f} is below its bound "
                 f"{entry['bound_ms']:.4f} ms")
    for sub, value in entry.items():
        if isinstance(value, dict):
            check_bounds(f"{name} {sub}", value)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------

#: the serve path whose run gives each kernel's launch count in the report
KERNEL_PATH = {"decode_attention": "dep", "moe_gemm": "dep",
               "flash_attention": "dep", "decode_attention_paged": "paged",
               "mlstm_scan": "xlstm", "rg_lru_scan": "hybrid",
               "mlstm_scan_backward": "train_recurrent xlstm-1.3b",
               "rg_lru_scan_backward": "train_recurrent recurrentgemma-9b"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-serve", action="store_true",
                    help="stop after the kernel and small-model phases")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then run the train phase alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    walls = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        walls[name] = time.perf_counter() - t0
        print(f"[phase] {name}: {walls[name]:.1f} s")
        return out

    phase("build", phase_build)
    if args.train_only:
        phase("train", phase_train)
        phase("train_recurrent", phase_train_recurrent)
        print(f"[phase] wall s: {json.dumps(walls)}")
        return 0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    entries = phase("kernels", lambda: [
        check_decode(gen), check_decode_paged(gen), check_moe_gemm(gen),
        check_flash(gen), check_mlstm(gen), check_rg_lru(gen),
        check_rg_lru_backward(gen), check_mlstm_backward(gen)])
    backbones = phase("backbone kernels", check_backbone_kernels, gen)
    phase("kernelcheck states", phase_kernelcheck_states, gen)
    torch.cuda.empty_cache()
    counts = {"quickstart": phase("small", phase_small)}
    phase("ring", phase_ring)
    cal_counts = {}
    if not args.no_serve:
        os.makedirs(os.path.join(ROOT, ".repro-profiles"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, ".repro-profiles")) as store_dir:
            profile, cal_counts = phase("calibrate", phase_calibrate,
                                        store_dir)
            torch.cuda.empty_cache()
            counts.update(phase("serve", phase_serve))
            counts["dep"] = phase("dep", phase_serve_dep, profile, store_dir)
            counts["placement"] = phase("placement", phase_placement,
                                        profile)
            phase("obs", phase_obs, profile, store_dir)
            for path in ("mla", "qwen3", "granite"):
                path_counts, extra = phase(path, phase_backbone, path,
                                           profile)
                counts.update(path_counts)
                for what, row in extra.items():
                    print(f"[{path} {what}] " + json.dumps(row))
            for path in ("qwen2-1.5b", "starcoder2", "command-r"):
                counts[path], readout = phase(path, phase_served, path)
                print(f"[{path} readout] " + json.dumps(readout))
            torch.distributed.destroy_process_group()
            counts["ep"] = phase("ep", phase_ep, profile)
            counts["xlstm"] = phase("xlstm", phase_serve_xlstm)
            counts["hybrid"] = phase("hybrid", phase_serve_hybrid)
            counts.update(phase("multimodal", phase_multimodal))
            counts["long"] = phase("long", phase_long)
            train_counts, train_gemm, _ = phase("train", phase_train)
            counts.update(train_counts)
            counts.update(phase("train_recurrent", phase_train_recurrent))
    print(f"[phase] wall s: {json.dumps(walls)}; total "
          f"{sum(walls.values()):.1f} s")

    report = []
    for e in entries:
        if e["name"] == "moe_gemm" and not args.no_serve:
            e = dict(e, backward_ms=train_gemm["bf16"]["backward_ms"],
                     train=train_gemm)
        at = {path: k[e["name"]] for path, k in backbones.items()
              if e["name"] in k}
        if at:
            e = dict(e, backbones=at)
        check_bounds(e["name"], e)
        path = KERNEL_PATH[e["name"]]
        launches = counts.get(path, {}).get(e["name"], 0)
        e = dict(e, route="cuda", launches=launches, launches_path=path,
                 launches_by_path={p: c[e["name"]] for p, c in counts.items()
                                   if c.get(e["name"])},
                 calibrate_launches=cal_counts.get(e["name"], 0), ok=True)
        report.append(e)
        lib = ("none" if e["library_ms"] is None
               else f"{e['library_ms']:.3f}")
        dev = (f", {e['device_ms']:.4f} on the device"
               if "device_ms" in e else "")
        print(f"[report] {e['name']}: {e['ms']:.3f} ms{dev} (plain "
              f"{e['plain_ms']:.3f}, library {lib}, bound "
              f"{e['bound_ms']:.4f} by {e['bound_by']}) at {e['shape']}; "
              f"{launches} launches while serving the {path} path")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(json.dumps({"kernels": report}))
    print(smi)
    if args.no_serve:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
