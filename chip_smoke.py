#!/usr/bin/env python3
# Copyright 2026.
#
# Licensed under the Apache License, Version 2.0 (the "License");
# you may not use this file except in compliance with the License.
# You may obtain a copy of the License at
#
#     http://www.apache.org/licenses/LICENSE-2.0
#
# Unless required by applicable law or agreed to in writing, software
# distributed under the License is distributed on an "AS IS" BASIS,
# WITHOUT WARRANTIES OR CONDITIONS OF ANY KIND, either express or implied.
# See the License for the specific language governing permissions and
# limitations under the License.

"""Smoke run of the PyTorch port's serving and training paths on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. Device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for float32 matmuls and convolutions.
2. Build: compiles ``last_torch_tpu_torch/csrc/viterbi.cu``,
   ``csrc/fused_scan.cu`` (which also holds the trigram kernels),
   ``csrc/numerator_scan.cu``, ``csrc/joint_head.cu`` and
   ``csrc/sharded_scan.cu`` for sm_90a, one nvcc each, side by side, and
   reports the registers and spills of each wgmma kernel (the bfloat16
   forwards' ``csrc/head_product.cuh`` among them).
3. Viterbi kernel against its plain PyTorch version on the card, T=64,
   B=4, V in {1024, 1000}, FD / FLD(1) / FLD(2), float32 and bfloat16, and
   with hat and log-softmax normalization (FD, FLD(2)).
3c. The joint+head kernels (``csrc/joint_head.cu``, ``JointWeightFn.apply``
   over every context state) against their plain versions: B in {1, 8},
   S in {1025, 4161, 1100}, V in {1024, 64, 1000}, h=512, float32 and
   bfloat16, values and gradients; and S=1100, V=1001 (the bfloat16
   forward's stores through shared memory, rows not 16-byte aligned).
4. Serving main path: ``GNATModel(presets.gnat_global_bigram(),
   device='cuda')`` with random weights from a seed decodes 8 requests at
   T_max=1600 through the kernel, is checked, and is compared with the same
   decode through the plain version; both are timed with CUDA events.
4b. HAT serving: ``GNATModel(presets.hat_bigram(vocab_size=1024))``
   decodes the same requests through the kernel's in-kernel hat
   normalization, checked and timed as phase 4.
5. Log-partition kernels (forward and backward) against their plain
   versions, at the shapes of phase 3, with zero-cotangent and empty rows.
5b. Numerator kernels against their plain versions: T=64, B=4, U+1=26,
   V in {1024, 1000}, float32 and bfloat16, hat and log-softmax, with a
   zero-cotangent row and padded frames and label positions; and V=1000 at
   hidden 1024 (float32) and 2048 (bfloat16), wide joints.
5c. Marginals kernel against its plain version at phase 5's shapes (and
   FLD(3), the bfloat16 route's last reduction with any number of pairs),
   on the same forward residuals; padding frames and the empty row exactly
   0.
5d. Online log-partition kernels against their plain versions and against
   the cache kernels at phase 5's shapes and at a ragged V=520.
5e. The trigram log-partition kernels (the trigram mode of
   ``csrc/fused_scan.cu``) against their plain versions: T=64, B=4, V=64
   (S=4161) and a ragged V=50, FD / FLD(1) / FLD(2), float32 and bfloat16,
   and the bfloat16 tile route (FLD(0), V=130), with zero-cotangent and
   empty rows.
6. Training main path: 3 ``train_step``s of the phase-4 model on 8
   utterances of up to 1600 frames through the log-partition kernels, timed
   with CUDA events; step 1's loss and gradients against the same step
   through the plain versions on the card; one more step under
   ``torch.profiler`` (device busy time, idle share); then each kernel
   alone against its plain version at the step's shapes, and the step's
   other parts.
6b. HAT training: 3 ``train_step``s of the phase-4b model on the same
   utterances through the numerator kernels (float32), step 1 held against
   the plain versions, one more step profiled; the numerator kernels alone
   (the forward's route checked under the profiler) and the step's parts.
7. The log-partition kernels alone at the JAX package's headline loss
   configuration (``bench.py::bench_headline``: B=32, T=1600, FLD(2),
   bf16).
7b. The HAT loss and the numerator kernels alone at bench.py's config 7
   (B=32, T=1600, U=100, bf16).
8. Confidence main path: phase 4's model, weights and requests through the
   encoder and ``RecognitionLattice.label_marginals`` (forward and
   marginals kernels), counted and timed, against the same call through
   the plain versions; posterior structure checked; the kernels alone
   (the bfloat16 marginals' route checked under the profiler);
   ``arc_marginals``' size guard, and its state sums at B=2, T=100 (the
   generic route, whose apply launches the joint+head forward kernel,
   counted) against the float32 plain label_marginals.
8b. label_marginals at bench.py's config 8 (the headline lattice, B=32,
   T=1600, bf16) through the kernels, and the kernels alone.
9. Large-vocabulary main path: 3 ``train_step``s of
   ``gnat_global_bigram(vocab_size=4096)`` on 8 utterances of phase 6's
   lengths / 8 (one label per 4 frames), in the mode ``log_partition``'s
   'auto' plans, step 1 against the plain versions, one step profiled;
   then a decode of the same utterances through the Viterbi kernel, checked
   as phase 4's.
9b. bench.py's config 9 (V=4096, B=8, T=200, FLD(2), bf16):
   ``log_partition(mode='online')`` forward and backward, counted; each
   mode's kernels alone against the plain versions, timed, with their peak
   device memory.
10. Trigram main path: 3 ``train_step``s of
   ``gnat_global_bigram(vocab_size=64, context_size=2)`` at full width on 8
   utterances of phase 9's lengths through the trigram kernels, step 1
   against the plain versions, one step profiled, the kernels alone at the
   step's shapes (the segment kernels, checked under the profiler); a
   decode of the same utterances on the generic route
   (no lattice kernel), rescored in float64 along its trigram state walk and held
   to the same route in float64; ``label_marginals`` (generic route),
   their structure checked. The generic decode and posteriors launch the
   joint+head forward kernel once per frame and once more per frame in
   their backward loop or recompute: counted.
10b. The trigram kernels alone at the JAX package's trigram probe shapes
   (V=64, S=4161, B=8, T=200, FLD(2), bf16) against their plain versions,
   their bounds with the joint's tanhf on the MUFU pipes (``bound``, at
   the SM clock nvidia-smi reports), and one forward and one backward by
   kernel (the segment kernels, and none of the first design's: checked):
   device ms a call, launches a frame, the pair's peak memory.
11. NextStateTable main path: the densified headline lattice
   (``bench.py::build_lattice(vocab=1024)`` with its context
   ``NextStateTable(FullNGram(1024, 1).next_state_table())``: S=1025,
   FLD(2), h=emb=feature=512, bf16 heads) at phase 6's utterances and label
   counts, no encoder. After a 16-frame warm-up of each route, step 1
   (loss mean and backward) through the joint+head plain versions, the
   FullNGram lattice's bigram kernels and its generic route
   (``fused='never'``, joint+head kernels), timed; 3 counted and timed
   train steps (``make_optimizer`` AdamW) through the joint+head kernels,
   losses falling, no lattice kernel launched, the first one's loss and
   gradients held to the three (the same function), the last one
   profiled; the generic decode against the Viterbi kernel's and
   ``label_marginals`` against the bigram marginals kernel's, each counted
   and timed.
11b. The joint+head kernels alone against their plain versions and the
   library compositions (tanh of the broadcast sum and addmm; the
   backward's two mm) at the densified headline's per-frame shape (B=8,
   S=1025, V=1024, bf16) and the trigram probe's (B=8, S=4161, V=64,
   float32).
12. Tensor-parallel main path: a one-process NCCL group (the card machine
   has one H100, and NCCL takes no two ranks on one GPU) and
   ``parallel.sharding.make_mesh(model_parallel=1)``;
   ``make_tp_train_step`` on ``gnat_global_bigram()`` at full width and
   phase 6's utterances. Step 1 of the lattice loss through the
   single-device bigram kernels, ``tp_lattice_loss`` (the same function)
   and ``tp_lattice_loss`` in float64: losses to rtol 1e-4, the
   tensor-parallel gradients within max(1e-3, twice the single-device
   route's error) of the float64 ones; 3 counted and timed steps through
   the ``frame_reduce`` kernels (``csrc/sharded_scan.cu``: 2 launches per
   frame each way under FLD(2), 3200 + 3200 per step), losses falling; one
   more step profiled. Then the data-parallel expected-risk (MWER) step
   (``make_shard_map_risk_train_step``, phase 13's settings) on the same
   group against the single-device ``risk_train_step(...,
   per_example_keys=True)`` from one seed: the same sampled paths, the
   metrics to rtol 1e-5, the gradients within 1e-5 of the largest. The
   process group is destroyed at the end of the phase.
12b. The ``frame_reduce`` kernels alone against their plain versions and
   the library composition (tanh, addmm, logsumexp; its autograd) at the
   headline per-frame shape (B=8, S=1025, h=512, Vl=1024, bf16) and at one
   of D=4 shards (Vl=256); then the D=4 shards in one process: red
   concatenated and the gradients combined, held to the D=1 kernels and
   the plain versions.
13. Expected-risk (MWER) main path: ``gnat_global_bigram()`` at full
   width on phase 6's utterances and labels, 4 posterior samples a row,
   estimator 'mwer', NLL weight 0.1. Step 1's objective through the kernels
   (the sampler's beta pass runs the float32 joint+head forward every
   frame, without autograd: both estimators' gradient through log Z is
   zero; the NLL term the bigram 'cache' pair) against the same objective
   through the plain versions on the paths the kernels' run drew, at two
   seeds: the sampler's log Z and log_prob within ``long_rtol`` nats (8
   float32 roundings of the largest |log Z|), log_prob at most that, the
   objective to rtol 1e-4, gradients within 1e-3 of the largest; labels in [0, V], padding slots 0. At the first seed the same step with
   the beta pass differentiated (the joint+head forward, its recompute and
   backward a frame) gives the same gradients. The share of equal slots
   when both routes draw from one seed (not judged). 3
   ``risk_train_step`` steps, each under the profiler (loss, mean_risk,
   nll, wall and device-busy ms, idle share, peak memory, the launches of
   each kernel, checked: 1600 joint+head forwards, one log-partition pair,
   nothing else), and a 4th without it; the step's parts alone (beta
   pass, draw, scoring, NLL term; the slot states' closed-form walk
   against the generic loop); the float32 joint+head pair at the beta
   pass's shape against its plain versions and library compositions; sum
   exp(log_prob) over the distinct samples of a peaked
   lattice, float32 and bfloat16 weight functions, kernel and plain.
13b. Forced alignment: ``align`` of phase 6's utterances and label
   sequences under ``gnat_global_bigram()`` (no lattice kernel: the GN
   string weights are ``JointWeightFn.label_weights``) and
   ``hat_bigram(vocab_size=1024)`` (the numerator forward kernel), timed:
   emit frames inside [0, num_frames), non-decreasing, -1 past num_labels;
   the scores equal the MaxTropical string DP's and a float64 rescoring of
   the returned alignment; the HAT run against the numerator's plain
   versions (scores to rtol 1e-5, differing rows must tie).
14. The CTC topology (S = 1, the factorized route: no lattice kernel) and
   path entropy. ``ctc_like(vocab_size=1024)`` at full width on phase 6's
   utterances: step 1 on the factorized route against the generic frame
   loop (phase 6's step rules), 3 AdamW train steps (CUDA events, each
   profiled: device busy time, idle share; nothing launched), a decode on
   both routes (float32, differing rows must tie in a float64 rescoring).
   Bench config 11's lattice (``gnat_global_bigram(context_size=0)``): the
   mean loss forward and backward at B=32 x 1600, U=100 (with and without
   the encoder, peak memory), against the generic route at B=8, and
   ``label_marginals`` at B=8 (posterior sums; against the generic route).
   Path entropy (``shortest_distance`` under ``LogLogExpectation`` with
   the entropy lift): ``hat_bigram(vocab_size=1024)`` at full width, B=8,
   T <= 400, through the float32 joint+head forward kernel once a frame
   (counted) and its plain version (``joint_head.using``); bench config
   4's shape (B=16, T=400, V=64, h=128, no kernel); the model of (a),
   factorized against generic. Every time beside the card's name and power
   limit.
15. Streaming serving and the trainer (``[stream-*]``, ``[rnn-cacher]``).
   (a) ``models.train.train`` of ``streaming_conformer_gnat()`` at full
   width (4 x 256 causal Conformer, window 64, conv 8, auto-banded) on
   synthetic B=8 x 1600 batches (U_max 100): step 1 against the plain
   versions, 3 steps with checkpoints at 2 and 3 and an evaluation through
   the Viterbi kernel, each step's ``StepTimer`` record, the restored state
   bit-equal to the saved one, a resumed run to step 4 (its 'restored'
   event), and the prefetch thread's batches on the card against their
   host arrays. (b) ``make_optimizer(accumulate_steps=2)``: no parameter
   moves after micro-step 1, the parameters move after micro-step 2. (c)
   ``gnat_global_bigram(use_rnn_cacher=True)`` on phase 6's batch: step 1
   against the plain versions in float32 and float64, 3 steps through the
   'cache' pair, a decode through the Viterbi kernel. (d) ``StreamingEncoder``
   in chunks of 16 and 64 frames against the offline (banded) encode
   within 1e-4, and banded against dense attention at B=8 x 1600 (outputs,
   gradients, peak memory). (e) The greedy and beam (4, max_labels 512)
   decoders on one offline encode, in chunks of 16 and in one chunk:
   identical; ``nbest_offline``; the serving loop (chunked encoder, then
   chunked decoders) against the offline path (>= 99.9% of label slots
   equal, a differing best hypothesis a tie when rescored), its per-chunk
   latency (CUDA events), device activities a chunk and real-time factor at
   an assumed 10 ms frame shift. (f) One ``train_step`` at B=8 x 6400 with
   the production encoder (512 x 4, 8 heads, bfloat16, banded): time, peak
   memory, log-partition mode. Their launches of the 'cache' pair and the
   Viterbi forward join the kernels line (``launches_by_path``).

16. Time sharding (``parallel/sequence.py``; ``[seq-*]``). (a) The
   log-partition kernels chained by their relay seeds (``alpha0`` /
   ``beta0``, the whole sequence's log Z) on phase 6's encoded batch: both
   modes' pairs over 4 blocks of 400 frames against one whole call and the
   plain versions chained the same way; at T_max 2000 a fifth block of
   padding only (alpha and beta passed through exactly, zero gradients);
   the trigram pair (phase 10's shape, segment route) over 2 blocks. Each
   block's backward peak memory against the whole call's, the chained
   time against the whole. (b) On a one-process NCCL group:
   ``make_time_sharded_train_step(fused='auto')`` on a ('seq',) mesh of 1,
   3 steps, step 1 against ``gnat.train_step``'s (loss rtol 1e-5,
   gradients 1e-3 of the largest); ``make_tp_seq_train_step`` on a 1 x 1
   ('seq', 'model') mesh, 2 steps, step 1 against ``make_tp_train_step``'s.
   (c) The relay's decode and alignment at phase 6's lengths / 4 against
   the single-device generic decode and ``align`` (float32 rules).
17. Pipeline and Megatron-sharded training (``parallel/pipeline.py``,
   ``parallel/sharding.py``; ``[pipeline]``, ``[sharded]``), on a
   one-process NCCL group, each axis one rank. (a) ``make_pp_train_step``
   on ('data', 'pipe') 1 x 1 at M = 2 (3 steps) and 4 (step 1), step 1
   against the whole batch's ``gnat.train_step`` (loss rtol 1e-5,
   gradients 1e-3 of the largest; a lattice leaf to max(1e-3, the
   whole-batch step's own distance from the float64 plain versions), and
   to float64 within max(1e-3, twice that distance)), 2M 'cache' forwards
   and M backwards a step (the last stage's forward recomputed in its
   backward). (b) ``make_pp_encode_fn`` against ``encoder.apply`` over the
   same microbatches (rtol 1e-5 / atol 1e-6) and on the whole batch
   (1e-5 of the encoding's largest entry). (c)
   ``make_pp_seq_train_step(fused='auto')`` on ('pipe', 'seq') 1 x 1 (the
   kernel relay), 2 steps, step 1 as (a)'s. (d) ``make_sharded_train_step``
   on ('data', 'model') 1 x 1 (the Megatron encoder, the lattice on the
   gathered head by its own route), 2 steps, step 1 against
   ``gnat.train_step``'s; then the fallback of ``train(model_parallel > 1)``
   on the trigram (``fused='never'``, the generic route through the
   joint+head kernels at S = 4161, phase 10's shape), step 1 against
   ``gnat.train_step`` on the same route. Their launches of the 'cache'
   and joint+head pairs join the kernels line.

Each phase prints one line or more with its seconds, and the run its total;
any failure exits non-zero before the last line, which is ``{"ok": true,
"device": {...}}``. The line before it is the kernels' JSON record: for each
kernel its launches on the main paths, its time and its plain version's at
the main path's shapes, and its bound on an H100 (published peaks). Imports
nothing of JAX.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

# Phase-4 and phase-6 utterance lengths (frames at 100 frames/s; 16 s at
# most), and phase 6's label counts, one label per 16 frames.
NUM_FRAMES = [1600, 1523, 1400, 1211, 1000, 804, 517, 230]
NUM_LABELS = [n // 16 for n in NUM_FRAMES]
TRAIN_STEPS = 3
LEARNING_RATE = 1e-3
# Tolerances, relative. float32: kernel and plain differ in summation order
# only. bfloat16: both round the same inputs; the f32 sums still differ in
# order, which can flip near-tied argmaxes (ROADMAP: bf16 decode near-ties).
F32_RTOL = 1e-5
BF16_RTOL = 1e-4
BF16_MIN_SLOT_AGREEMENT = 0.999
# Log-partition kernels against their plain versions. Log-space values
# (alpha, log Z, beta) relative to max(|value|, 1); gradients as
# |a - b|max / |b|max per output. A gradient is a sum of marginals, each the
# exp of a sum of log-space terms as large as |log Z|, so float32 sums in
# another order move it by ~|log Z| * 6e-8 relative: 1e-4 in float32, as
# the JAX package's own kernel tests allow its gradients. bfloat16: a
# float32 tanh on either side of a bfloat16 rounding boundary moves a joint
# entry by one bfloat16 step.
LP_RTOL = {'float32': (F32_RTOL, 1e-4), 'bfloat16': (BF16_RTOL, 1e-3)}
# At full lengths the log-space values themselves reach |log Z| ~ 1e4, where
# one float32 rounding is ~|log Z| * 2**-24 absolute (~6e-4), in either
# version: the gradient tolerance is then 8 such roundings relative.
LP_LONG_ROUNDINGS = 8
# Training step 1, kernels against plain versions (bfloat16 heads): the
# loss relative, and each parameter gradient as |a - b|max over the
# largest gradient of the step, as the CPU parity tests judge GNAT
# gradients. A leaf's own scale does not do: its gradient is the
# denominator's minus the numerator's, which largely cancel (FLD's blank_b
# wholly: every path takes one blank arc per frame), while the kernels'
# bfloat16 residue scales with the denominator's part alone. On an H100 the
# GN step reads 9.18e-4 (blank_b), the MWER step 9.10e-4 to 9.11e-4
# (blank_b) and 7.67e-4 to 7.68e-4 (blank_w) at two sampling seeds alike:
# the gap is the 'cache' pair's in the NLL term, fixed by the weights and
# the batch, which the sampled paths do not reach.
STEP_LOSS_RTOL = 1e-4
STEP_GRAD_RTOL = 1e-3
# HAT training step 1 (float32, no denominator to cancel against): each
# parameter gradient as |a - b|max over its own |b|max. Two H100 runs read
# at most 8.62e-06 (vocab_w), so 1e-4 leaves about ten times that.
HAT_STEP_GRAD_RTOL = 1e-4


class SmokeFailure(Exception):
  pass


def check(condition, message):
  if not condition:
    raise SmokeFailure(message)


def card_line():
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, timeout=60,
      check=True).stdout.strip().splitlines()
  return out[0]


def rand(rng, shape, scale=1.0):
  return (rng.standard_normal(shape) * scale).astype(np.float32)


def timed(torch, fn, repeats=1):
  """(result of the last call, ms per call) with CUDA events."""
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(repeats):
    result = fn()
  end.record()
  torch.cuda.synchronize()
  return result, start.elapsed_time(end) / repeats


def normalized(torch, lex, blank, normalize):
  """(c, normalized blank) of the local normalization: each lexical weight
  of a state loses c, as in the kernels; c is 0 for 'none'."""
  if normalize == 'none':
    return torch.zeros_like(blank), blank
  lse = torch.logsumexp(lex, dim=-1)
  zero = torch.zeros_like(blank)
  if normalize == 'hat':
    return (lse + torch.logaddexp(blank, zero),
            -torch.logaddexp(-blank, zero))
  c = torch.logaddexp(blank, lse)
  return c, blank - c


def rescore(torch, labels, num_frames, pf, pc, params, *, max_expansions,
            frame_dependent, compute_dtype, normalize='none', context=None):
  """Scores of the given alignments under the plain arc weights (float64).

  Walks each alignment through the context (the bigram's unless a
  ``context`` is given): a lexical slot y from state q scores lex[q, y]
  (less q's normalizer c[q]) and moves to the state after q and y (y
  itself in the bigram); the frame's blank slot scores blank[q]
  (normalized).
  """
  rnd = lambda x: x.to(compute_dtype).float()
  vw = rnd(params['vocab_w'])
  vw_t = vw.t()
  bw = rnd(params['blank_w'])
  max_t, batch, _ = pf.shape
  num_align = 1 if frame_dependent else max_expansions + 1
  slots = labels.view(batch, max_t, num_align).long()
  q = torch.zeros(batch, dtype=torch.long, device=pf.device)
  score = torch.zeros(batch, dtype=torch.float64, device=pf.device)
  for t in range(max_t):
    real = t < num_frames
    for i in range(num_align):
      y = slots[:, t, i]
      joint = rnd(torch.tanh(pc[q] + pf[t]))
      lexical = ((joint * vw_t[(y - 1).clamp(min=0)]).sum(-1) +
                 params['vocab_b'][(y - 1).clamp(min=0)])
      blank = joint @ bw + params['blank_b']
      if normalize != 'none':
        lex = joint.double() @ vw.double() + params['vocab_b'].double()
        c, blank = normalized(torch, lex, blank.double(), normalize)
        lexical = lexical.double() - c
      is_blank_slot = frame_dependent or i == num_align - 1
      if is_blank_slot:
        weight = torch.where(y > 0, lexical, blank)
      else:
        weight = torch.where(y > 0, lexical, torch.zeros_like(lexical))
      score += torch.where(real, weight, 0.0).double()
      after = y if context is None else context.next_state(q, y)
      q = torch.where(real & (y > 0), after, q)
  return score


def relative(torch, a, b):
  """|a - b| / max(|b|, 1), elementwise in float64."""
  return (a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)


def compare_decodes(torch, got, want, rescored, dtype):
  """Checks a kernel decode against a plain one; returns a report string.

  ``rescored`` is the kernel's alignment scored under the plain weights.
  """
  labels_k, num_k, weights_k = got
  labels_p, num_p, weights_p = want
  check(torch.equal(num_k, num_p), 'num_alignment_labels differ')
  rtol = F32_RTOL if dtype == torch.float32 else BF16_RTOL
  rel = relative(torch, weights_k, weights_p)
  check(bool((rel <= rtol).all()),
        f'path weights differ by {rel.max().item():.3g} relative (> {rtol})')
  rescored_rel = relative(torch, rescored, weights_k)
  check(bool((rescored_rel <= rtol).all()),
        'the kernel alignment rescored by the plain weights is '
        f'{rescored_rel.max().item():.3g} relative from its path weight')
  real_slots = (torch.arange(labels_k.shape[1], device=labels_k.device)[None]
                < num_k[:, None])
  differ = (labels_k != labels_p) & real_slots
  report = (f'weights max rel {rel.max().item():.2e}, rescored max rel '
            f'{rescored_rel.max().item():.2e}')
  if dtype == torch.float32:
    # A label difference is accepted only as a true tie: the kernel's path
    # scores, under the plain weights, what the plain best path scores.
    tied_rows = [b for b in range(labels_k.shape[0]) if bool(differ[b].any())]
    tie_rel = relative(torch, rescored, weights_p)
    for b in tied_rows:
      check(tie_rel[b].item() <= F32_RTOL,
            f'row {b}: labels differ and the paths score apart')
    report += (', labels equal' if not tied_rows else
               f', labels differ on tied rows {tied_rows}')
  else:
    total = int(real_slots.sum())
    agreement = 1.0 - int(differ.sum()) / max(total, 1)
    check(agreement >= BF16_MIN_SLOT_AGREEMENT,
          f'label slots agree on {agreement:.5f} < {BF16_MIN_SLOT_AGREEMENT}')
    report += f', slot agreement {agreement:.5f} of {total}'
  return report


def tie_gaps(torch, viterbi, inputs, kw, got, want):
  """Score gaps where the kernel's and the plain version's tables differ.

  For each differing arg entry (t, b, pass j, label y) or jstar entry (t, b,
  state s), both choices are rescored in float64 from the plain version's
  alpha before frame t: a gap within F32_RTOL means the two sums, taken in
  different orders, fell on either side of a true tie.
  """
  pf, pc, params, is_pad = inputs
  arg_k, jstar_k, _ = got
  arg_p, jstar_p, _ = want
  diffs = ([('arg', *i) for i in (arg_k != arg_p).nonzero().tolist()] +
           [('jstar', *i) for i in (jstar_k != jstar_p).nonzero().tolist()])
  check(len(diffs) <= 100, f'{len(diffs)} table entries differ')
  rnd = lambda x: x.to(kw['compute_dtype']).double()
  vw, vb = rnd(params['vocab_w']), params['vocab_b'].double()
  bw, bb = rnd(params['blank_w']), params['blank_b'].double()
  gaps = []
  for kind, t, b, *where in diffs:
    alpha_t = viterbi.viterbi_forward_plain(
        pf[:t].contiguous(), pc, params, is_pad[:t].contiguous(),
        **kw)[2][b].double()
    joint = rnd(torch.tanh(pc + pf[t, b]))  # [S, h]
    lex = joint @ vw + vb
    c, blank = normalized(torch, lex, joint @ bw + bb, kw['normalize'])
    vecs = [alpha_t]  # each pass's input: alpha, then expand(red)
    for _ in range(arg_k.shape[2]):
      red = ((vecs[-1] - c)[:, None] + lex).max(dim=0).values
      vecs.append(torch.cat([red.new_full((1,), float('-inf')), red]))
    if kind == 'arg':
      j, y = where
      score = lambda s: (vecs[j][s] - c[s]) + lex[s, y]
      mine, theirs = int(arg_k[t, b, j, y]), int(arg_p[t, b, j, y])
    else:
      (s,) = where
      score = lambda jj: vecs[jj][s] + blank[s]
      mine, theirs = int(jstar_k[t, b, s]), int(jstar_p[t, b, s])
    a, c = score(mine).item(), score(theirs).item()
    gaps.append(abs(a - c) / max(abs(c), 1.0))
  return len(diffs), max(gaps, default=0.0)


def phase_kernel_vs_plain(torch, viterbi):
  """Phase 3: the kernel against its plain version on the card, without
  and with local normalization."""
  rng = np.random.default_rng(1)
  max_t, batch, hidden = 64, 4, 512
  num_frames = torch.tensor([64, 50, 0, 17], device='cuda')
  is_pad = (torch.arange(max_t, device='cuda')[:, None] >=
            num_frames[None, :])
  lines = []
  for vocab in (1024, 1000):
    pf = torch.from_numpy(rand(rng, (max_t, batch, hidden))).cuda()
    pc = torch.from_numpy(rand(rng, (vocab + 1, hidden))).cuda()
    params = {
        'vocab_w': torch.from_numpy(rand(rng, (hidden, vocab),
                                         hidden**-0.5)).cuda(),
        'vocab_b': torch.from_numpy(rand(rng, (vocab,), 0.1)).cuda(),
        'blank_w': torch.from_numpy(rand(rng, (hidden,), hidden**-0.5)).cuda(),
        'blank_b': torch.tensor(0.3, device='cuda'),
    }
    cases = [(name, k, fd, 'none') for name, k, fd in
             (('FD', 0, True), ('FLD(1)', 1, False), ('FLD(2)', 2, False))]
    cases += [(name, k, fd, normalize) for name, k, fd in
              (('FD', 0, True), ('FLD(2)', 2, False))
              for normalize in ('hat', 'log_softmax')]
    for name, k, fd, normalize in cases:
      for dtype in (torch.float32, torch.bfloat16):
        kw = dict(max_expansions=k, frame_dependent=fd, compute_dtype=dtype,
                  normalize=normalize)
        fwd_k = viterbi.viterbi_forward(pf, pc, params, is_pad, **kw)
        fwd_p = viterbi.viterbi_forward_plain(pf, pc, params, is_pad, **kw)
        torch.cuda.synchronize()
        bt = dict(max_expansions=k, frame_dependent=fd)
        labels_k, weights_k = viterbi.backtrace(*fwd_k, is_pad, **bt)
        labels_p, weights_p = viterbi.backtrace(*fwd_p, is_pad, **bt)
        num = (1 if fd else k + 1) * num_frames
        tag = f'V={vocab} {name} {str(dtype)[6:]} normalize={normalize}'
        tables = ''
        if dtype == torch.float32:
          num_diffs, gap = tie_gaps(torch, viterbi, (pf, pc, params, is_pad),
                                    kw, fwd_k, fwd_p)
          check(gap <= F32_RTOL, f'{tag}: arg/jstar differ in {num_diffs} '
                f'entries, choices scoring {gap:.3g} relative apart')
          tables = (', arg/jstar equal' if not num_diffs else
                    f', arg/jstar differ in {num_diffs} true ties (gap '
                    f'{gap:.1e})')
        rescored = rescore(torch, labels_k, num_frames, pf, pc, params, **kw)
        try:
          report = compare_decodes(
              torch, (labels_k, num, weights_k), (labels_p, num, weights_p),
              rescored, dtype)
        except SmokeFailure as e:
          raise SmokeFailure(f'{tag}: {e}') from None
        check(weights_k[2].item() == 0.0 and not bool(labels_k[2].any()),
              f'{tag}: the empty utterance is not all-blank at weight 0')
        lines.append(f'{tag}: {report}{tables}')
  return lines


# The wgmma kernels whose registers and spills phase 2 reports one by one
# (the rest only as each library's range).
WGMMA_KERNELS = ('lex_pass_kernel', 'head_grad_kernel', 'joint_grad_kernel',
                 'num_joint_grad_kernel', 'lex_grad_kernel',
                 'joint_pass_kernel', 'stage_kernel', 'head_product_kernel',
                 'column_reduce_kernel', 'column_max_kernel',
                 'row_reduce_kernel', 'row_lse_kernel', 'head_kernel',
                 'grad_kernel', 'lex_rows_kernel', 'lex_labels_kernel',
                 'head_grad_rows_kernel', 'head_grad_labels_kernel')
# The namespaces of those kernels (others share some of their names); simt:
# the numerator's float32 register-blocked products; fp32: the joint+head's
# (both on csrc/simt_tiles.cuh); segments: the bfloat16 trigram's.
WGMMA_NAMESPACES = ('hopper', 'head_grads', 'head_product', 'simt', 'fp32',
                    'segments')


def ptxas_kernels(log):
  """(mangled name, registers, spill store bytes, spill load bytes) of each
  kernel in an ``nvcc -Xptxas -v`` log."""
  kernels, name, spills = [], None, (0, 0)
  for line in log.splitlines():
    found = re.search(r"Compiling entry function '([^']+)'", line)
    if found:
      name = found.group(1)
    found = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
    if found:
      spills = int(found.group(1)), int(found.group(2))
    found = re.search(r'Used (\d+) registers', line)
    if found and name is not None:
      kernels.append((name, int(found.group(1)), *spills))
      name, spills = None, (0, 0)
  return kernels


def kernel_label(mangled, name):
  """``name`` with its integer and bool template arguments, if any, from a
  mangled kernel name (``column_reduce_kernel<1>``, ``lex_pass_kernel<2,
  true>``: the marginals scan's last reduction)."""
  found = re.search(name + r'I((?:L[ib]n?\d+E)+)E', mangled)
  if not found:
    return name
  args = [('true' if value == '1' else 'false') if kind == 'b' else
          f'{"-" if minus else ""}{value}' for kind, minus, value in
          re.findall(r'L([ib])(n?)(\d+)E', found.group(1))]
  return f'{name}<{", ".join(args)}>'


def phase_build(build, libraries):
  """Phase 2: builds every kernel library at once, one nvcc per source.

  ``libraries`` maps a csrc/ source to the module whose ``library()``
  builds and loads it. A stale library of each source is removed first.
  Returns one report line per source, and one per source that holds wgmma
  kernels with each one's registers and spills.
  """
  for source in libraries:
    build.library_path(source).unlink(missing_ok=True)

  def build_one(module):
    t0 = time.perf_counter()
    module.library()
    return time.perf_counter() - t0

  with concurrent.futures.ThreadPoolExecutor(len(libraries)) as pool:
    seconds = list(pool.map(build_one, libraries.values()))
  lines = []
  for source, s in zip(libraries, seconds):
    log = build.library_path(source).with_suffix('.log').read_text()
    registers = [int(w.split()[0]) for w in log.split('Used ')[1:]]
    spill_stores = sum(int(line.split('bytes spill stores')[0].split(',')[-1])
                       for line in log.splitlines()
                       if 'bytes spill stores' in line)
    spill_loads = sum(int(line.split('bytes spill loads')[0].split(',')[-1])
                      for line in log.splitlines()
                      if 'bytes spill loads' in line)
    lines.append(f'{source} for sm_90a in {s:.1f} s; ptxas: '
                 f'{len(registers)} kernels, {min(registers)}-'
                 f'{max(registers)} registers, spill stores {spill_stores} B, '
                 f'spill loads {spill_loads} B')
    wgmma = [f'{"simt::" if "4simt" in mangled else ""}'
             f'{"fp32::" if "4fp32" in mangled else ""}'
             f'{"segments::" if "8segments" in mangled else ""}'
             f'{kernel_label(mangled, name)} {regs} registers, spills '
             f'{stores}/{loads} B' for mangled, regs, stores, loads in
             ptxas_kernels(log) for name in WGMMA_KERNELS
             if f'{len(name)}{name}' in mangled and
             any(space in mangled for space in WGMMA_NAMESPACES)]
    if wgmma:
      lines.append(f'{source} wgmma kernels (stores/loads): ' +
                   '; '.join(wgmma))
  return lines


def max_errors(torch, got, want, names, rtols):
  """Largest error of each output of a kernel against its plain version.

  ``rtols`` is (value rtol, gradient rtol); names ending in '*' are
  log-space values, compared as relative(); the others gradients, as
  |a - b|max / |b|max. Infinities must match exactly. Returns
  {name: (error, max abs error)}; raises on an error above its rtol.
  """
  errors = {}
  for name, a, b in zip(names, got, want):
    if b is None:
      check(a is None, f'{name}: kernel wrote what plain did not')
      continue
    finite = torch.isfinite(b)
    check(torch.equal(finite, torch.isfinite(a)) and
          torch.equal(a[~finite], b[~finite]),
          f'{name}: kernel and plain differ in their infinities')
    a, b = a[finite].double(), b[finite].double()
    abs_err = (a - b).abs().max().item() if a.numel() else 0.0
    if name.endswith('*'):
      err = relative(torch, a, b).max().item() if a.numel() else 0.0
      rtol = rtols[0]
    else:
      scale = b.abs().max().item() if b.numel() else 0.0
      err = abs_err / scale if scale else (0.0 if abs_err == 0 else np.inf)
      rtol = rtols[1]
    check(err <= rtol, f'{name}: kernel vs plain {err:.3g} > {rtol}')
    errors[name.rstrip('*')] = (err, abs_err)
  return errors


FORWARD_NAMES = ('log_z*', 'alpha*', 'hist*', 'slabs*')
BACKWARD_NAMES = ('dpf', 'dpc', 'd_vocab_w', 'd_vocab_b', 'd_blank_w',
                  'd_blank_b', 'beta_out*')
MARGINALS_NAMES = ('bm', 'lp')
ALIGNMENT_CASES = (('FD', 0, True), ('FLD(1)', 1, False),
                   ('FLD(2)', 2, False))
# Phases 5, 5c and 5d: T=64, B=4; row 1 has 50 frames, row 2 none, row 3
# 17; in the backward row 1 has a zero cotangent.
LP_NUM_FRAMES = [64, 50, 0, 17]
LP_G = [1.0, 0.0, 0.7, 1.3]


def lp_inputs(torch, rng, vocab, max_t=64, batch=4, hidden=512, states=None):
  """Random kernel inputs (pf, pc, head) of the log-partition phases, over
  ``states`` context states (the bigram's V + 1 by default)."""
  pf = torch.from_numpy(rand(rng, (max_t, batch, hidden))).cuda()
  pc = torch.from_numpy(rand(rng, (vocab + 1 if states is None else states,
                                   hidden))).cuda()
  params = {
      'vocab_w': torch.from_numpy(rand(rng, (hidden, vocab),
                                       hidden**-0.5)).cuda(),
      'vocab_b': torch.from_numpy(rand(rng, (vocab,), 0.1)).cuda(),
      'blank_w': torch.from_numpy(rand(rng, (hidden,), hidden**-0.5)).cuda(),
      'blank_b': torch.tensor(0.3, device='cuda'),
  }
  return pf, pc, params


def padding(torch, num_frames, max_t):
  """[T, B] bool, True on padding frames."""
  num_frames = torch.as_tensor(num_frames, device='cuda')
  return torch.arange(max_t, device='cuda')[:, None] >= num_frames[None, :]


def phase_log_partition_vs_plain(torch, fused_scan):
  """Phase 5: the log-partition kernels against their plain versions."""
  rng = np.random.default_rng(2)
  is_pad = padding(torch, LP_NUM_FRAMES, 64)
  # Row 1 has a zero cotangent, row 2 no frames: both get exact zeros.
  g = torch.tensor(LP_G, device='cuda')
  lines = []
  for vocab in (1024, 1000):
    pf, pc, params = lp_inputs(torch, rng, vocab)
    for name, k, fd in ALIGNMENT_CASES:
      for dtype in (torch.float32, torch.bfloat16):
        kw = dict(max_expansions=k, frame_dependent=fd, compute_dtype=dtype)
        tag = f'V={vocab} {name} {str(dtype)[6:]}'
        fwd_k = fused_scan.fused_forward(pf, pc, params, is_pad,
                                         with_residuals=True, **kw)
        fwd_p = fused_scan.fused_forward_plain(pf, pc, params, is_pad,
                                               with_residuals=True, **kw)
        bwd_k = fused_scan.fused_backward(pf, pc, params, is_pad, fwd_k[0], g,
                                          fwd_k[2], fwd_k[3], **kw)
        bwd_p = fused_scan.fused_backward_plain(pf, pc, params, is_pad,
                                                fwd_p[0], g, fwd_p[2],
                                                fwd_p[3], **kw)
        torch.cuda.synchronize()
        rtols = LP_RTOL[str(dtype)[6:]]
        try:
          errors = max_errors(torch, fwd_k, fwd_p, FORWARD_NAMES, rtols)
          errors.update(max_errors(torch, bwd_k, bwd_p, BACKWARD_NAMES,
                                   rtols))
        except SmokeFailure as e:
          raise SmokeFailure(f'{tag}: {e}') from None
        dpf, beta_out = bwd_k[0], bwd_k[-1]
        check(fwd_k[0][2].item() == 0.0 and bool((beta_out[2] == 0).all()),
              f'{tag}: the empty row has log Z or beta_out != 0')
        check(not bool(dpf[:, 1:3].any()),
              f'{tag}: the g = 0 row or the empty row has nonzero d(pf)')
        value = max(e for n, (e, _) in errors.items() if n in
                    ('log_z', 'alpha', 'hist', 'slabs', 'beta_out'))
        grad_name, (grad, _) = max(
            ((n, e) for n, e in errors.items() if n.startswith('d')),
            key=lambda item: item[1][0])
        lines.append(f'{tag}: values max rel {value:.2e}, gradients max rel '
                     f'{grad:.2e} ({grad_name}); g=0 and empty rows exactly 0')
  return lines


def phase_marginals_vs_plain(torch, fused_scan):
  """Phase 5c: the marginals kernel against its plain version, both on the
  same forward residuals (from the forward kernel)."""
  rng = np.random.default_rng(7)
  is_pad = padding(torch, LP_NUM_FRAMES, 64)
  lines = []
  for vocab in (1024, 1000):
    pf, pc, params = lp_inputs(torch, rng, vocab)
    # FLD(3): the bfloat16 route's last reduction with any number of pairs.
    for name, k, fd in ALIGNMENT_CASES + (('FLD(3)', 3, False),):
      for dtype in (torch.float32, torch.bfloat16):
        kw = dict(max_expansions=k, frame_dependent=fd, compute_dtype=dtype)
        tag = f'V={vocab} {name} {str(dtype)[6:]}'
        log_z, _, hist, slabs = fused_scan.fused_forward(
            pf, pc, params, is_pad, with_residuals=True, **kw)
        residuals = (log_z, hist, slabs)
        got = fused_scan.fused_marginals(pf, pc, params, is_pad, *residuals,
                                         **kw)
        want = fused_scan.fused_marginals_plain(pf, pc, params, is_pad,
                                                *residuals, **kw)
        torch.cuda.synchronize()
        try:
          errors = max_errors(torch, got, want, MARGINALS_NAMES,
                              LP_RTOL[str(dtype)[6:]])
        except SmokeFailure as e:
          raise SmokeFailure(f'marginals {tag}: {e}') from None
        for x in got:
          check(not bool(x[is_pad].any()),
                f'marginals {tag}: padding frames or the empty row not 0')
        lines.append(f'{tag}: bm max rel {errors["bm"][0]:.2e}, lp max rel '
                     f'{errors["lp"][0]:.2e}; padding and empty rows exactly '
                     '0')
  return lines


def phase_online_vs_plain(torch, fused_scan):
  """Phase 5d: the online kernels against their plain versions and against
  the cache kernels on the same inputs; V=520 runs several label strips
  with a ragged last one."""
  rng = np.random.default_rng(8)
  is_pad = padding(torch, LP_NUM_FRAMES, 64)
  g = torch.tensor(LP_G, device='cuda')
  lines = []
  for vocab in (1024, 1000, 520):
    pf, pc, params = lp_inputs(torch, rng, vocab)
    for name, k, fd in ALIGNMENT_CASES:
      for dtype in (torch.float32, torch.bfloat16):
        kw = dict(max_expansions=k, frame_dependent=fd, compute_dtype=dtype)
        tag = f'V={vocab} {name} {str(dtype)[6:]}'
        runs = {}
        for mode, forward, backward in (
            ('online', fused_scan.fused_forward, fused_scan.fused_backward),
            ('cache', fused_scan.fused_forward, fused_scan.fused_backward),
            ('plain', fused_scan.fused_forward_plain,
             fused_scan.fused_backward_plain)):
          fwd_mode = 'cache' if mode == 'plain' else mode
          fwd = forward(pf, pc, params, is_pad, with_residuals=True,
                        mode=fwd_mode, **kw)
          bwd = backward(pf, pc, params, is_pad, fwd[0], g, fwd[2], fwd[3],
                         mode=fwd_mode, **kw)
          runs[mode] = (fwd, bwd)
        torch.cuda.synchronize()
        rtols = LP_RTOL[str(dtype)[6:]]
        worst = {}
        for against in ('plain', 'cache'):
          try:
            errors = max_errors(torch, runs['online'][0], runs[against][0],
                                FORWARD_NAMES, rtols)
            errors.update(max_errors(torch, runs['online'][1],
                                     runs[against][1], BACKWARD_NAMES, rtols))
          except SmokeFailure as e:
            raise SmokeFailure(f'online {tag} vs {against}: {e}') from None
          worst[against] = max((e, n) for n, (e, _) in errors.items())
        (log_z, *_), (dpf, *_, beta_out) = runs['online']
        check(log_z[2].item() == 0.0 and bool((beta_out[2] == 0).all()),
              f'online {tag}: the empty row has log Z or beta_out != 0')
        check(not bool(dpf[:, 1:3].any()),
              f'online {tag}: the g = 0 row or the empty row has nonzero '
              'd(pf)')
        lines.append(
            f'{tag}: vs plain max rel {worst["plain"][0]:.2e} '
            f'({worst["plain"][1]}), vs cache kernels '
            f'{worst["cache"][0]:.2e} ({worst["cache"][1]}); g=0 and empty '
            'rows exactly 0')
  return lines


def plain_mean_loss(torch, model, plain_log_partition, semirings, params,
                    frames, num_frames, labels, num_labels):
  """``GNATModel.mean_loss`` with the log-partition's plain versions
  (``plain_log_partition``, a route's 'plain')."""
  lattice = model.lattice
  lattice_params = params['lattice']
  encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  cache = lattice.build_cache(lattice_params)
  denominator = plain_log_partition(
      lattice_params['weight_fn'], cache, encoded, num_frames,
      max_expansions=lattice.alignment.max_expansions, frame_dependent=False,
      compute_dtype=torch.bfloat16)
  numerator = lattice._string_forward(lattice_params, cache, encoded,
                                      num_frames, labels, num_labels,
                                      semirings.Log)
  per_seq = denominator - numerator
  finite = torch.isfinite(per_seq)
  return torch.where(finite, per_seq, 0.0).sum() / finite.sum().clamp(min=1)


def loss_and_grads(torch, leaves, loss_fn):
  """(loss, [gradient of each leaf]) of one forward and backward."""
  for leaf in leaves:
    leaf.grad = None
  loss = loss_fn()
  loss.backward()
  torch.cuda.synchronize()
  return loss.item(), [leaf.grad.clone() for leaf in leaves]


def say(phase, line):
  print(f'[{phase}] {line}', flush=True)


LP_COUNTERS = {'cache': ('forward_launches', 'backward_launches'),
               'online': ('online_forward_launches',
                          'online_backward_launches')}


def reset_counts(*modules):
  """Sets every kernel launch count of the given wrapper modules to 0."""
  for module in modules:
    for name in dir(module):
      if name.endswith('launches'):
        setattr(module, name, 0)


def counts(module):
  """{name: count} of a wrapper module's kernel launch counts."""
  return {name: getattr(module, name) for name in dir(module)
          if name.endswith('launches')}


def bigram_route(torch, fused_scan, config, batch_size):
  """The log-partition route of a bigram GN model for ``train_and_check``:
  the mode 'auto' plans, its kernels' counters, the other mode's (which
  must stay at 0) and the plain versions' log Z."""
  mode = fused_scan.plan(batch_size, config.vocab_size + 1, config.vocab_size,
                         torch.bfloat16)
  other = 'online' if mode == 'cache' else 'cache'
  return {'name': mode, 'module': fused_scan, 'counters': LP_COUNTERS[mode],
          'idle': [(fused_scan, n) for n in LP_COUNTERS[other]],
          'plain': functools.partial(
              fused_scan.log_partition, mode=mode,
              forward=fused_scan.fused_forward_plain,
              backward=fused_scan.fused_backward_plain),
          'report': f'log-partition mode {mode!r} (plan for \'auto\')'}


def trigram_route(fused_scan, trigram_scan):
  """The log-partition route of a trigram GN model for ``train_and_check``:
  the trigram kernels, with every bigram log-partition counter idle."""
  return {'name': 'trigram', 'module': trigram_scan,
          'counters': ('forward_launches', 'backward_launches'),
          'idle': [(fused_scan, n) for n in counts(fused_scan)],
          'plain': functools.partial(
              trigram_scan.log_partition,
              forward=trigram_scan.trigram_forward_plain,
              backward=trigram_scan.trigram_backward_plain),
          'report': 'trigram log-partition kernels'}


def step1_vs_plain(torch, pytree, semirings, model, params, batch, route,
                   phase):
  """Step 1 of a GN model: its mean loss and gradients through the lattice
  kernels against the same through their plain versions (``route``'s
  'plain'), loss to STEP_LOSS_RTOL, gradients to STEP_GRAD_RTOL of the
  largest. Prints its line; returns the kernels' loss."""
  leaves = pytree.tree_leaves(params)
  t0 = time.perf_counter()
  loss_k, grads_k = loss_and_grads(
      torch, leaves, lambda: model.mean_loss(params, *batch))
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  loss_p, grads_p = loss_and_grads(
      torch, leaves, lambda: plain_mean_loss(torch, model, route['plain'],
                                             semirings, params, *batch))
  loss_rel = abs(loss_k - loss_p) / abs(loss_p)
  check(np.isfinite(loss_k) and loss_rel <= STEP_LOSS_RTOL,
        f'step-1 loss {loss_k} through the kernels, {loss_p} plain')
  paths = [pytree.keystr(path) for path, _ in
           pytree.tree_flatten_with_path(params)[0]]
  largest = max(g.abs().max().item() for g in grads_p)
  worst = own = (0.0, '')
  for path, a, b in zip(paths, grads_k, grads_p):
    check(bool(torch.isfinite(a).all()), f'{path}: gradient not finite')
    diff = (a - b).abs().max().item()
    worst = max(worst, (diff / largest, path))
    own = max(own, (diff / max(b.abs().max().item(), 1e-30), path))
  check(worst[0] <= STEP_GRAD_RTOL,
        f'step-1 gradient of {worst[1]}: kernel vs plain {worst[0]:.3g} of '
        f'the largest gradient')
  for leaf in leaves:
    leaf.grad = None
  say(phase, f'step 1 through the kernels vs plain versions: loss '
             f'{loss_k:.6g} vs {loss_p:.6g} (rel {loss_rel:.2e}); '
             f'gradients, {len(leaves)} leaves, max |a-b| {worst[0]:.2e} '
             f'of the largest gradient {largest:.3g} ({worst[1]}); of the '
             f'leaf\'s own scale at most {own[0]:.2e} ({own[1]}) '
             f'({time.perf_counter() - t0:.1f} s)')
  return loss_k


def train_and_check(torch, gnat, semirings, pytree, config, num_frames_list,
                    num_labels_list, phase, route, step1=step1_vs_plain):
  """A GN training main path: step 1 through the kernels against the same
  step through their plain versions, then TRAIN_STEPS counted and timed
  train steps (their losses finite and falling), then one more step under
  the profiler. Utterances: random features from numpy seed 0 at the given
  lengths, random labels at the given counts. ``route`` names the
  log-partition kernels the model must take (``bigram_route``,
  ``trigram_route``); ``step1`` judges step 1 (``step1_vs_plain``). Prints
  its lines; returns (model, optimizer, state, batch, (forward, backward)
  launches of the route's kernels)."""
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  rng = np.random.default_rng(0)
  batch_size, max_t = len(num_frames_list), max(num_frames_list)
  frames = torch.from_numpy(
      rand(rng, (batch_size, max_t, config.feature_size))).cuda()
  labels = torch.from_numpy(rng.integers(
      1, config.vocab_size + 1,
      size=(batch_size, max(num_labels_list)))).cuda()
  num_frames = torch.tensor(num_frames_list, device='cuda')
  num_labels = torch.tensor(num_labels_list, device='cuda')
  batch = (frames, num_frames, labels, num_labels)
  real_frames = sum(num_frames_list)
  module, names = route['module'], route['counters']

  loss_k = step1(torch, pytree, semirings, model, state.params, batch, route,
                 phase)

  # The main path: train steps through the kernels, counted and timed.
  losses, step_ms, per_step = [], [], []
  reset_counts(module, *{m for m, _ in route['idle']})
  for _ in range(TRAIN_STEPS):
    before = [getattr(module, n) for n in names]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    state, loss = gnat.train_step(model, optimizer, state, *batch)
    end.record()
    torch.cuda.synchronize()
    step_ms.append(start.elapsed_time(end))
    losses.append(loss.item())
    per_step.append(tuple(getattr(module, n) - c
                          for n, c in zip(names, before)))
  launches = tuple(getattr(module, n) for n in names)
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  check(all(f >= 1 and b >= 1 for f, b in per_step),
        f'a train step did not launch both {route["name"]} kernels: '
        f'{per_step}')
  check(all(getattr(m, n) == 0 for m, n in route['idle']),
        f'the train steps launched kernels off their route: '
        f'{[(m.__name__, n) for m, n in route["idle"] if getattr(m, n)]}')
  check(all(np.isfinite(losses)) and
        all(b < a for a, b in zip(losses, losses[1:])),
        f'losses not finite and decreasing: {losses}')
  check(abs(losses[0] - loss_k) <= 1e-6 * abs(loss_k),
        f'train step 1 loss {losses[0]} != mean_loss {loss_k}')
  say(phase,
      f'gnat_global_bigram(vocab_size={config.vocab_size}, context_size='
      f'{config.context_size}) B={batch_size} T_max={max_t} '
      f'U_max={max(num_labels_list)}, {TRAIN_STEPS} train steps: losses '
      + ', '.join(f'{x:.6g}' for x in losses) +
      '; step ms ' + ', '.join(f'{x:.1f}' for x in step_ms) + ' ('
      + ', '.join(f'{real_frames / x * 1e3:.0f}' for x in step_ms)
      + f' real frames/s); {route["report"]}; kernel launches per step '
      f'(forward, backward) {per_step}; last_path kernel')

  say(phase, 'one more step under the profiler: ' + device_profile(
      torch, lambda: gnat.train_step(model, optimizer, state, *batch))[1])
  return model, optimizer, state, batch, launches


def phase_training(torch, gnat, presets, fused_scan, semirings, pytree):
  """Phase 6: the training main path. Prints its lines; returns the
  log-partition kernels' records for the JSON line."""
  config = presets.gnat_global_bigram()
  route = bigram_route(torch, fused_scan, config, len(NUM_FRAMES))
  check(route['name'] == 'cache',
        f'the V=1024 step planned {route["name"]!r}, not cache')
  model, optimizer, state, batch, launches = train_and_check(
      torch, gnat, semirings, pytree, config, NUM_FRAMES, NUM_LABELS, 'train',
      route)
  frames, num_frames, labels, num_labels = batch
  batch_size, max_t = frames.shape[:2]
  # Each kernel alone against its plain version at the step's shapes, and
  # the step's other parts alone (these launches are not counted).
  params = state.params
  lattice_params = params['lattice']
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  _, pf, pc, head = staged_lattice_inputs(torch, model.lattice,
                                          lattice_params, encoded)
  is_pad = padding(torch, num_frames, max_t)
  g = torch.full((batch_size,), 1.0 / batch_size, device='cuda')
  kw = dict(max_expansions=config.max_expansions, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  records = kernels_alone(torch, bigram_kernels(fused_scan, 'cache'), pf, pc,
                          head, is_pad, g, kw, launches)
  records.pop('plain')
  say('train', records.pop('line'))

  # The step's other parts, each alone: encoder forward + backward,
  # numerator (string DP over label_weights) forward + backward, the
  # optimizer update.
  def encoder_fwd_bwd():
    out = model.encoder.apply(params['encoder'], frames, num_frames)
    out.backward(torch.ones_like(out))

  def numerator_fwd_bwd():
    enc = encoded.detach().requires_grad_(True)
    numerator = model.lattice._string_forward(
        lattice_params, model.lattice.build_cache(lattice_params), enc,
        num_frames, labels, num_labels, semirings.Log)
    numerator.sum().backward()

  _, encoder_ms = timed(torch, encoder_fwd_bwd)
  _, numerator_ms = timed(torch, numerator_fwd_bwd)
  _, optimizer_ms = timed(
      torch, lambda: optimizer.apply_gradients(state.opt_state))
  say('train', f'step parts alone: encoder forward+backward '
               f'{encoder_ms:.1f} ms, numerator forward+backward '
               f'{numerator_ms:.1f} ms, optimizer update {optimizer_ms:.1f} '
               f'ms; log-partition kernels {records["forward"]["ms"]:.1f} + '
               f'{records["backward"]["ms"]:.1f} ms')
  return records


# The JSON names of the log-partition kernels by mode, and the lines of
# the TPU kernels they replace in last_torch_tpu/ops/fused_scan.py.
LP_KERNELS = {'cache': (('fused_forward', 122), ('fused_backward', 255)),
              'online': (('online_forward', 712), ('online_backward', 867))}


def judge_by_float64(torch, kernels, pf, pc, head, is_pad, g, kw, bwd_k,
                     bwd_p, grad_rtol):
  """Holds the kernel's gradients to the plain versions run in float64 (the
  same bfloat16 roundings of the joint and head, float64 sums): each output
  |kernel - ref|max / |ref|max within max(grad_rtol, twice the float32
  plain version's). A gradient summed over thousands of states with
  cancellation (d(pf)) carries float32's log-space rounding in either
  version. Returns a report."""
  head_64 = {n: x.double() for n, x in head.items()}
  fwd_64 = kernels['forward_plain'](pf.double(), pc.double(), head_64, is_pad,
                                    with_residuals=True, **kw)
  bwd_64 = kernels['backward_plain'](pf.double(), pc.double(), head_64,
                                     is_pad, fwd_64[0], g.double(), fwd_64[2],
                                     fwd_64[3], **kw)
  report = []
  for name, k, p, ref in zip(BACKWARD_NAMES, bwd_k, bwd_p, bwd_64):
    if name.endswith('*'):
      continue
    scale = ref.abs().max().item()
    err_k = (k.double() - ref).abs().max().item() / scale
    err_p = (p.double() - ref).abs().max().item() / scale
    check(err_k <= max(grad_rtol, 2 * err_p),
          f'{name}: kernel {err_k:.3g} from the float64 reference, float32 '
          f'plain {err_p:.3g}')
    report.append(f'{name} {err_k:.2e} (plain {err_p:.2e})')
  return ('; gradients vs the float64 plain versions, kernel (float32 '
          'plain): ' + ', '.join(report))


def bigram_kernels(fused_scan, mode):
  """The bigram log-partition kernels of ``mode`` for ``kernels_alone``."""
  (fwd_name, fwd_line), (bwd_name, bwd_line) = LP_KERNELS[mode]
  return {'forward': functools.partial(fused_scan.fused_forward, mode=mode),
          'backward': functools.partial(fused_scan.fused_backward, mode=mode),
          'forward_plain': fused_scan.fused_forward_plain,
          'backward_plain': fused_scan.fused_backward_plain,
          'records': ((fwd_name, f'fused_scan.py:{fwd_line}'),
                      (bwd_name, f'fused_scan.py:{bwd_line}')),
          # The bfloat16 forward's kernels (both modes) live in the header
          # it shares with the frame reduction, the joint+head forward and
          # the Viterbi forward.
          'sources': ('head_product.cuh', 'fused_scan.cu'),
          'label': f'log-partition kernels alone, {mode} mode'}


def trigram_kernels(trigram_scan):
  """The trigram log-partition kernels for ``kernels_alone``."""
  return {'forward': trigram_scan.trigram_forward,
          'backward': trigram_scan.trigram_backward,
          'forward_plain': trigram_scan.trigram_forward_plain,
          'backward_plain': trigram_scan.trigram_backward_plain,
          'sources': ('fused_scan.cu', 'fused_scan.cu'),
          'records': (('trigram_forward', 'trigram_scan.py:380'),
                      ('trigram_backward', 'trigram_scan.py:689')),
          # The function needs the joint once a frame-row each way (the
          # backward's tanh derivative and d_vw read the same joint); the
          # segment kernels form it twice backward (head_kernel and
          # grad_kernel), a cost of the design stated beside the bound.
          'tanh_joints': (1, 1),
          'design_joints': (1, 2),
          'label': 'trigram log-partition kernels alone'}


def kernels_alone(torch, kernels, pf, pc, head, is_pad, g, kw, launches,
                  plain=None, float64_reference=False):
  """A log-partition kernel pair (``bigram_kernels``, ``trigram_kernels``)
  alone against its plain versions, timed once each with CUDA events, with
  the JSON records of both kernels and the peak device memory of the kernel
  pair (inputs included). ``plain``: the plain versions' (outputs, ms) from
  an earlier call on the same inputs, returned as 'plain'; timed anew when
  None. With ``float64_reference`` the gradients are judged against the
  plain versions run in float64 on the same bfloat16-rounded products: the
  kernel must be within max(gradient rtol, twice the float32 plain
  version's own error) of that reference (``judge_by_float64``)."""
  torch.cuda.synchronize()
  resident = torch.cuda.memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  fwd_k, fwd_ms = timed(torch, lambda: kernels['forward'](
      pf, pc, head, is_pad, with_residuals=True, **kw))
  forward_peak = peak = torch.cuda.max_memory_allocated()
  torch.cuda.reset_peak_memory_stats()
  bwd_k, bwd_ms = timed(torch, lambda: kernels['backward'](
      pf, pc, head, is_pad, fwd_k[0], g, fwd_k[2], fwd_k[3], **kw))
  backward_peak = torch.cuda.max_memory_allocated()
  peak = max(peak, backward_peak)
  if plain is None:
    fwd_p, plain_fwd_ms = timed(
        torch, lambda: kernels['forward_plain'](
            pf, pc, head, is_pad, with_residuals=True, **kw))
    bwd_p, plain_bwd_ms = timed(
        torch, lambda: kernels['backward_plain'](
            pf, pc, head, is_pad, fwd_p[0], g, fwd_p[2], fwd_p[3], **kw))
    plain = (fwd_p, plain_fwd_ms, bwd_p, plain_bwd_ms)
  fwd_p, plain_fwd_ms, bwd_p, plain_bwd_ms = plain
  value_rtol, grad_rtol = LP_RTOL['bfloat16']
  log_z_max = fwd_p[0].abs().max().item()
  grad_rtol = max(grad_rtol, LP_LONG_ROUNDINGS * 2.0**-24 * log_z_max)
  rtols = value_rtol, grad_rtol
  fwd_err = max_errors(torch, fwd_k, fwd_p, FORWARD_NAMES, rtols)
  judged = ''
  if float64_reference:
    # Gradients: kernel against plain unjudged here (abs errors only), both
    # against float64.
    bwd_err = max_errors(torch, bwd_k, bwd_p, BACKWARD_NAMES,
                         (value_rtol, np.inf))
    judged = judge_by_float64(torch, kernels, pf, pc, head, is_pad, g, kw,
                              bwd_k, bwd_p, grad_rtol)
  else:
    bwd_err = max_errors(torch, bwd_k, bwd_p, BACKWARD_NAMES, rtols)
  max_t, batch, hidden = pf.shape
  line = (f'{kernels["label"]}, bf16 B={batch} '
          f'T={max_t} S={pc.shape[0]} V={head["vocab_w"].shape[1]} '
          f'h={hidden} FLD({kw["max_expansions"]}): forward kernel '
          f'{fwd_ms:.1f} ms, plain {plain_fwd_ms:.1f} ms; backward kernel '
          f'{bwd_ms:.1f} ms, plain {plain_bwd_ms:.1f} ms; peak device memory '
          f'of the kernel pair {peak / 2**20:.0f} MiB, of the forward '
          f'{forward_peak / 2**20:.0f} MiB, of the backward '
          f'{backward_peak / 2**20:.0f} MiB ({resident / 2**20:.0f} '
          f'MiB resident before); vs plain (|log Z| up to {log_z_max:.4g}, '
          f'gradient rtol {grad_rtol:.2e}): '
          + ', '.join(f'{n} {e:.2e}' for n, (e, _) in
                      {**fwd_err, **bwd_err}.items()) + judged)
  # The least work either mode could do: one head product per real
  # frame-row (the cache mode's later reductions of a frame read the staged
  # lex); the backward runs three.
  rows = int((~is_pad).sum())
  flops = 2.0 * rows * pc.shape[0] * head['vocab_w'].numel()
  inputs = nbytes(pf, pc, *head.values(), is_pad)
  fwd_bytes = inputs + nbytes(*fwd_k)
  bwd_bytes = inputs + nbytes(fwd_k[0], g, fwd_k[2], fwd_k[3], *bwd_k)
  (fwd_name, fwd_replaces), (bwd_name, bwd_replaces) = kernels['records']
  fwd_source, bwd_source = kernels['sources']
  # The joint's tanhf a frame-row, once per joint the function needs (the
  # trigram pair's 'tanh_joints'; the bigram kernels' bound omits it: there
  # the product binds).
  fwd_joints, bwd_joints = kernels.get('tanh_joints', (0, 0))
  tanh = rows * pc.numel()
  record = lambda name, source, replaces, count, err, ms, plain_ms, ops, \
      traffic, joints: kernel_record(name, source, replaces, count, err, ms,
                                     plain_ms, ops, traffic, 'bfloat16',
                                     tanh=joints * tanh)
  fwd_bound = bound(flops, fwd_bytes, 'bfloat16', fwd_joints * tanh)[0]
  bwd_bound = bound(3 * flops, bwd_bytes, 'bfloat16', bwd_joints * tanh)[0]
  terms = ''
  if fwd_joints:
    design = kernels['design_joints']
    terms = (f' (products {flops / PEAK_OPS["bfloat16"] * 1e3:.3g} / '
             f'{3 * flops / PEAK_OPS["bfloat16"] * 1e3:.3g} ms, tanhf '
             f'{tanh_ms(fwd_joints * tanh):.3g} / '
             f'{tanh_ms(bwd_joints * tanh):.3g} ms: {fwd_joints} / '
             f'{bwd_joints} joints a frame-row, {MUFU_PER_TANH} MUFU '
             f'operations each at {MUFU_PER_SM_CLOCK} a clock on '
             f'{CARD["sms"]} SMs at {CARD["clock_mhz"]} MHz; the kernels '
             f'form {design[0]} / {design[1]} joints a frame-row, tanhf '
             f'{tanh_ms(design[0] * tanh):.3g} / '
             f'{tanh_ms(design[1] * tanh):.3g} ms)')
  return {
      'line': line + f'; bounds {fwd_bound:.3g} / {bwd_bound:.3g} ms' + terms,
      'forward': record(fwd_name, fwd_source, fwd_replaces, launches[0],
                        fwd_err['log_z'][1], fwd_ms, plain_fwd_ms, flops,
                        fwd_bytes, fwd_joints),
      'backward': record(bwd_name, bwd_source, bwd_replaces, launches[1],
                         max(e[1] for n, e in bwd_err.items()
                             if n != 'beta_out'), bwd_ms, plain_bwd_ms,
                         3 * flops, bwd_bytes, bwd_joints),
      'plain': plain,
      'peak': peak,
      'forward_peak': forward_peak,
      'backward_peak': backward_peak,
  }


def bench_lattice(torch, lattices, contexts, alignments, weight_fns, vocab,
                  hidden=512, context_size=1):
  """bench.py::build_lattice's GN lattice (FLD(2), SharedEmbCacher and
  joint hidden ``hidden``, bfloat16 heads on the card), with parameters from
  seed 0; ``context_size=2`` gives the trigram lattice of the JAX package's
  trigram probe (benchmarks/tpu_trigram_probe.py)."""
  lattice = lattices.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=context_size),
      alignment=alignments.FrameLabelDependent(max_expansions=2),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=hidden),
      weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
          vocab_size=vocab, hidden_size=hidden))
  params = lattice.init(torch.Generator().manual_seed(0), feature_size=hidden,
                        device='cuda')
  return lattice, params


def phase_headline(torch, lattices, contexts, alignments, weight_fns, gnat,
                   presets, fused_scan, semirings, pytree):
  """Phase 7: the lattice loss at bench.py::bench_headline's configuration
  (no encoder: frames are 512-wide features), through the kernels, and
  gnat_global_bigram's encoder alone at that batch; prints its lines."""
  vocab, hidden, batch_size, max_t, max_u = 1024, 512, 32, 1600, 100
  lattice, params = bench_lattice(torch, lattices, contexts, alignments,
                                  weight_fns, vocab, hidden)
  leaves = pytree.tree_leaves(params)
  for leaf in leaves:
    leaf.requires_grad_(True)
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(
      rand(rng, (batch_size, max_t, hidden), 0.1)).cuda()
  num_frames = torch.full((batch_size,), max_t, device='cuda')
  labels = torch.from_numpy(
      rng.integers(1, vocab + 1, size=(batch_size, max_u))).cuda()
  num_labels = torch.full((batch_size,), max_u, device='cuda')

  def loss_fwd_bwd():
    loss = lattice.loss(params, frames, num_frames, labels, num_labels)
    loss.sum().backward()

  def numerator_fwd_bwd():
    lattice._string_forward(params, lattice.build_cache(params), frames,
                            num_frames, labels, num_labels,
                            semirings.Log).sum().backward()

  _, loss_ms = timed(torch, loss_fwd_bwd)
  check(lattice.last_path == 'kernel',
        'the headline loss did not take the kernels')
  check(all(bool(torch.isfinite(leaf.grad).all()) for leaf in leaves),
        'headline gradients not finite')
  _, numerator_ms = timed(torch, numerator_fwd_bwd)
  say('headline', f'lattice loss forward+backward (bench_headline config: '
      f'B={batch_size} T={max_t} U={max_u} feature=emb=hidden={hidden} '
      f'V={vocab} FLD(2), bf16 heads) {loss_ms:.1f} ms '
      f'({batch_size * max_t / loss_ms * 1e3:.0f} frames/s), log-partition '
      f'mode {fused_scan.plan(batch_size, vocab + 1, vocab, torch.bfloat16)!r}'
      f' (plan for \'auto\'); numerator forward+backward {numerator_ms:.1f} '
      'ms')
  cache, pf, pc, head = staged_lattice_inputs(torch, lattice, params, frames)
  is_pad = torch.zeros((max_t, batch_size), dtype=torch.bool, device='cuda')
  g = torch.ones((batch_size,), device='cuda')
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  records = kernels_alone(torch, bigram_kernels(fused_scan, 'cache'), pf, pc,
                          head, is_pad, g, kw, (None, None))
  say('headline', records['line'])
  del pf, pc, records, cache, frames

  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  encoder_params = model.init(torch.Generator().manual_seed(0))['encoder']
  for leaf in pytree.tree_leaves(encoder_params):
    leaf.requires_grad_(True)
  features = torch.from_numpy(
      rand(rng, (batch_size, max_t, config.feature_size))).cuda()

  def encoder_fwd_bwd():
    out = model.encoder.apply(encoder_params, features, num_frames)
    out.backward(torch.ones_like(out))

  _, encoder_ms = timed(torch, encoder_fwd_bwd)
  say('headline', f'gnat_global_bigram encoder forward+backward at B='
      f'{batch_size} T={max_t}: {encoder_ms:.1f} ms')


# Published dense peaks of one H100 SXM (NVIDIA's data sheet, at 700 W):
# operations per second by input type, and device-memory bytes per second.
PEAK_OPS = {'bfloat16': 989e12, 'float32': 67e12}
PEAK_BYTES = 3.35e12
# A tanhf is 2 MUFU operations (ex2, rcp: tools/tanh_sass.py counts them in
# the SASS), and an SM's special-function units take 16 a clock. main()
# fills CARD with the SM count and the SM clock nvidia-smi reports
# (clocks.max.sm).
MUFU_PER_TANH = 2
MUFU_PER_SM_CLOCK = 16
CARD = {}


def tanh_ms(tanh):
  """The least time the card's MUFU pipes take for ``tanh`` tanhf."""
  rate = CARD['sms'] * MUFU_PER_SM_CLOCK * CARD['clock_mhz'] * 1e6
  return tanh * MUFU_PER_TANH / rate * 1e3


def bound(flops, nbytes, dtype, tanh=0):
  """(bound_ms, bound_by): the least time the card could take for flops
  operations in dtype, ``tanh`` tanhf on the MUFU pipes and nbytes of
  device-memory traffic."""
  ops_ms = max(flops / PEAK_OPS[dtype] * 1e3, tanh_ms(tanh) if tanh else 0.0)
  bytes_ms = nbytes / PEAK_BYTES * 1e3
  return (max(ops_ms, bytes_ms),
          'operations' if ops_ms >= bytes_ms else 'bytes')


def card_clock():
  """(SMs, max SM clock MHz) of card 0, the clock as nvidia-smi reports it
  (clocks.max.sm)."""
  import torch
  out = subprocess.run(
      ['nvidia-smi', '--query-gpu=clocks.max.sm', '--format=csv,noheader,'
       'nounits', '--id=0'], capture_output=True, text=True, timeout=60,
      check=False).stdout.strip()
  check(out.isdigit(), f'nvidia-smi gave no SM clock ({out!r})')
  return torch.cuda.get_device_properties(0).multi_processor_count, int(out)


def nbytes(*tensors):
  """Bytes of the given tensors (each read or written once)."""
  return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def kernel_record(name, source, replaces, launches, max_abs_err, ms,
                  plain_ms, flops, traffic, dtype, tanh=0, **extra):
  """One entry of the kernels JSON line. No single PyTorch call computes a
  tropical or log-semiring lattice scan, or a head product fused with its
  logsumexp and a label select, so library_ms is null here; the joint+head
  records set it to their library composition's time. ``tanh``: the
  joint's tanhf the kernel must take (the trigram pair), in the bound."""
  bound_ms, bound_by = bound(flops, traffic, dtype, tanh)
  return {'name': name, 'route': 'cuda',
          'source': f'last_torch_tpu_torch/csrc/{source}',
          'replaces': f'last_torch_tpu/ops/{replaces}',
          'launches': launches, 'max_abs_err': max_abs_err, 'ms': ms,
          'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by,
          'library_ms': None, **extra}


def device_spans(torch, fn):
  """Runs fn once under torch.profiler (CUDA activity only: host-side
  tracing of a train step's ~100k small ops would take minutes to
  process). Returns (fn's result, the sorted (start us, end us, name) of
  its device activities), read from the profiler's raw events: building
  its event tree for a step of ~400k kernels takes minutes."""
  from torch.profiler import ProfilerActivity, profile
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    result = fn()
    torch.cuda.synchronize()
  cuda = torch.autograd.DeviceType.CUDA
  results = getattr(prof.profiler, 'kineto_results', None)
  check(results is not None, 'torch.profiler keeps no kineto_results here: '
        'the raw device events cannot be read')
  spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                 for e in results.events() if e.device_type() == cuda)
  check(bool(spans), 'the profiler recorded no device activity')
  return result, spans


def device_ms(torch, fn, repeats):
  """The device time of one call of fn: the summed durations of its device
  activities over ``repeats`` calls under the profiler, per call, apart
  from the host time that can bound a short call timed back to back."""
  _, spans = device_spans(torch, lambda: [fn() for _ in range(repeats)])
  return sum(stop - start for start, stop, _ in spans) / repeats / 1e3


def device_profile(torch, fn):
  """Runs fn once under torch.profiler (``device_spans``). Returns (fn's
  result, report): kernels, device busy time (the union of the kernels'
  intervals), the first-to-last-kernel window, the idle share of that
  window, and the three kernels with the most device time."""
  result, spans = device_spans(torch, fn)
  busy, end, by_name = 0.0, spans[0][0], {}
  for start, stop, name in spans:
    busy += max(0.0, stop - max(start, end))
    end = max(end, stop)
    by_name[name] = by_name.get(name, 0.0) + (stop - start)
  window = end - spans[0][0]
  top = sorted(by_name.items(), key=lambda item: -item[1])[:3]
  return result, (
      f'{len(spans)} kernels, device busy {busy / 1e3:.1f} ms of a '
      f'{window / 1e3:.1f} ms window (idle {1 - busy / window:.1%}); '
      'most device time: ' + ', '.join(
          f'{name[:48]} {t / 1e3:.1f} ms' for name, t in top))


def decode_split(decode_ms, forward_ms, backtrace_ms):
  """The decode's time split into the Viterbi forward, the backtrace and
  the rest (encoder, projections, glue: the decode's time less the two,
  each timed alone on the same inputs)."""
  rest = decode_ms - forward_ms - backtrace_ms
  return (f'decode split: Viterbi forward {forward_ms:.1f} ms '
          f'({forward_ms / decode_ms:.1%}), backtrace {backtrace_ms:.1f} ms '
          f'({backtrace_ms / decode_ms:.1%}), the rest {rest:.1f} ms '
          f'({rest / decode_ms:.1%}) of {decode_ms:.1f} ms')


def phase_hat_serving(torch, gnat, presets, viterbi):
  """Phase 4b: the HAT serving main path, hat_bigram(vocab_size=1024) at
  full width, decoding phase 4's requests through the kernel's in-kernel
  normalization. Prints its lines; returns (launches, kernel ms, plain ms,
  max abs err of the final alpha)."""
  config = presets.hat_bigram(vocab_size=1024)
  model = gnat.GNATModel(config)  # the card is the default device
  params = model.init(torch.Generator().manual_seed(0))
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(
      rand(rng, (len(NUM_FRAMES), max(NUM_FRAMES), config.feature_size))
  ).cuda()
  num_frames = torch.tensor(NUM_FRAMES, device='cuda')
  decode = lambda: model.decode(params, frames, num_frames)
  decode()  # warm-up
  torch.cuda.synchronize()
  viterbi.launches = 0
  (labels, num_labels, weights), decode_ms = timed(torch, decode)
  launches = viterbi.launches
  check(launches >= 1, 'the HAT decode did not launch the Viterbi kernel')
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  num_align = config.max_expansions + 1
  check(torch.equal(num_labels, num_align * num_frames.int()),
        'num_alignment_labels != 3 * num_frames')
  check(int(labels.min()) >= 0 and int(labels.max()) <= config.vocab_size,
        'labels outside [0, V]')
  slot = torch.arange(labels.shape[1], device='cuda')[None]
  check(not bool(labels[slot >= num_labels[:, None]].any()),
        'padding slots are not blank')
  check(bool(torch.isfinite(weights).all()) and bool((weights <= 0).all()),
        'HAT path weights are not finite log-probabilities')

  wf_params = params['lattice']['weight_fn']
  fwd = dict(max_expansions=config.max_expansions, frame_dependent=False,
             compute_dtype=torch.bfloat16, normalize='hat')
  encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  cache = model.lattice.build_cache(params['lattice'])
  plain_decode = lambda: viterbi.viterbi_decode(
      wf_params, cache, encoded, num_frames, **fwd,
      forward=viterbi.viterbi_forward_plain)
  plain_out, plain_decode_ms = timed(torch, plain_decode)
  pf = torch.einsum('btf,fh->tbh', encoded,
                    wf_params['frame_proj']).contiguous()
  pc = (cache @ wf_params['context_proj']).contiguous()
  rescored = rescore(torch, labels, num_frames, pf, pc, wf_params, **fwd)
  report = compare_decodes(torch, (labels, num_labels, weights), plain_out,
                           rescored, torch.bfloat16)
  real_frames = sum(NUM_FRAMES)
  say('hat-serving', f'hat_bigram B={len(NUM_FRAMES)} '
      f'T_max={max(NUM_FRAMES)}: kernel decode {decode_ms:.1f} ms '
      f'({real_frames / decode_ms * 1e3:.0f} frames/s), plain decode '
      f'{plain_decode_ms:.1f} ms, launches {launches}; vs plain: {report}')

  is_pad = (torch.arange(frames.shape[1], device='cuda')[:, None] >=
            num_frames[None, :])
  viterbi.viterbi_forward(pf, pc, wf_params, is_pad, **fwd)  # warm-up
  (_, _, alpha_k), kernel_ms = timed(
      torch, lambda: viterbi.viterbi_forward(pf, pc, wf_params, is_pad,
                                             **fwd), repeats=3)
  (_, _, alpha_p), plain_ms = timed(
      torch, lambda: viterbi.viterbi_forward_plain(pf, pc, wf_params, is_pad,
                                                   **fwd))
  forward_out = viterbi.viterbi_forward(pf, pc, wf_params, is_pad, **fwd)
  _, backtrace_ms = timed(
      torch, lambda: viterbi.backtrace(
          *forward_out, is_pad, max_expansions=config.max_expansions,
          frame_dependent=False), repeats=3)
  say('hat-serving', decode_split(decode_ms, kernel_ms, backtrace_ms))
  finite = torch.isfinite(alpha_p)
  check(torch.equal(finite, torch.isfinite(alpha_k)),
        'HAT final alpha: kernel and plain differ in reachable states')
  max_abs_err = (alpha_k[finite] - alpha_p[finite]).abs().max().item()
  scale = alpha_p[finite].abs().max().item()
  check(max_abs_err <= BF16_RTOL * scale,
        f'HAT final alpha differs by {max_abs_err} (scale {scale})')
  say('hat-serving', f'viterbi_forward normalize=hat bf16 B=8 T=1600 '
      f'S=1025 V=1024 h=512: kernel {kernel_ms:.1f} ms, plain '
      f'{plain_ms:.1f} ms; final alpha max abs err {max_abs_err:.3g} of '
      f'scale {scale:.4g}')
  return launches, kernel_ms, plain_ms, max_abs_err


NUMERATOR_FORWARD_NAMES = ('nb*', 'nl*', 'z*', 'blank*')
NUMERATOR_BACKWARD_NAMES = ('d_pc', 'd_pf', 'd_vocab_w', 'd_vocab_b',
                            'd_blank_w', 'd_blank_b', 'd_wy', 'd_by')
# Numerator kernels against their plain versions: (value rtol, gradient
# rtol). float32: summation order only. bfloat16: a float32 tanh on either
# side of a rounding boundary moves a joint entry by one bfloat16 step, and
# ds is rounded too. Each frame's weights stand alone (no recurrence), so
# these hold at any length.
NUM_RTOL = {'float32': (F32_RTOL, 1e-4), 'bfloat16': (BF16_RTOL, 2e-3)}


def numerator_cotangents(torch, num_frames, num_labels, u1, max_t):
  """Cotangents that vanish where the string DP's do: frames past
  num_frames and label positions past num_labels; batch row 1 is zero
  throughout. Returns (g_b, g_l), [T, B * U1]."""
  rng = np.random.default_rng(3)
  batch = len(num_frames)
  t = torch.arange(max_t, device='cuda')[:, None, None]
  u = torch.arange(u1, device='cuda')[None, None, :]
  live = ((t < num_frames[None, :, None]) &
          (u <= num_labels[None, :, None]))
  live[:, 1] = False
  g = [torch.from_numpy(rand(rng, (max_t, batch, u1))).cuda() * live
       for _ in range(2)]
  return [x.reshape(max_t, batch * u1).contiguous() for x in g]


def phase_numerator_vs_plain(torch, numerator_scan):
  """Phase 5b: the numerator kernels against their plain versions, with
  zero-cotangent and padded rows."""
  rng = np.random.default_rng(4)
  max_t, batch, u1 = 64, 4, 26
  num_frames = torch.tensor([64, 50, 0, 17], device='cuda')
  num_labels = torch.tensor([25, 10, 0, 3], device='cuda')
  g_b, g_l = numerator_cotangents(torch, num_frames, num_labels, u1, max_t)
  rows = batch * u1
  lines = []
  # (vocab, hidden, compute types): wide joints at hidden 1024 (float32)
  # and 2048 (bfloat16).
  f32, bf16 = torch.float32, torch.bfloat16
  for vocab, hidden, dtypes in ((1024, 512, (f32, bf16)),
                                (1000, 512, (f32, bf16)),
                                (1000, 1024, (f32,)), (1000, 2048, (bf16,))):
    head = {
        'vocab_w': torch.from_numpy(rand(rng, (hidden, vocab),
                                         hidden**-0.5)).cuda(),
        'vocab_b': torch.from_numpy(rand(rng, (vocab,), 0.1)).cuda(),
        'blank_w': torch.from_numpy(rand(rng, (hidden,), hidden**-0.5)).cuda(),
        'blank_b': torch.tensor(0.3, device='cuda'),
    }
    pc = torch.from_numpy(rand(rng, (rows, hidden), 0.5)).cuda()
    pf = torch.from_numpy(rand(rng, (max_t, batch, hidden), 0.5)).cuda()
    wy = torch.from_numpy(rand(rng, (rows, hidden), hidden**-0.5)).cuda()
    by = torch.from_numpy(rand(rng, (rows,), 0.1)).cuda()
    for hat in (True, False):
      for dtype in dtypes:
        kw = dict(hat=hat, compute_dtype=dtype)
        tag = (f'V={vocab} h={hidden} {"hat" if hat else "log_softmax"} '
               f'{str(dtype)[6:]}')
        fwd_k = numerator_scan.numerator_forward(pc, pf, head, wy, by, **kw)
        fwd_p = numerator_scan.numerator_forward_plain(pc, pf, head, wy, by,
                                                       **kw)
        bwd_k = numerator_scan.numerator_backward(
            pc, pf, head, wy, by, fwd_k[2], fwd_k[3], g_b, g_l, **kw)
        bwd_p = numerator_scan.numerator_backward_plain(
            pc, pf, head, wy, by, fwd_p[2], fwd_p[3], g_b, g_l, **kw)
        torch.cuda.synchronize()
        rtols = NUM_RTOL[str(dtype)[6:]]
        try:
          errors = max_errors(torch, fwd_k, fwd_p, NUMERATOR_FORWARD_NAMES,
                              rtols)
          errors.update(max_errors(torch, bwd_k, bwd_p,
                                   NUMERATOR_BACKWARD_NAMES, rtols))
        except SmokeFailure as e:
          raise SmokeFailure(f'numerator {tag}: {e}') from None
        d_pc, d_pf, d_wy = bwd_k[0], bwd_k[1], bwd_k[6]
        dead = ~numerator_live_rows(torch, num_labels, u1)
        check(not bool(d_pf[:, 1:3].any()) and
              not bool(d_pf[17:, 3].any()) and not bool(d_pf[50:, 1].any()),
              f'numerator {tag}: zero-cotangent frames have nonzero d(pf)')
        check(not bool(d_pc[dead].any()) and not bool(d_wy[dead].any()),
              f'numerator {tag}: padded rows have nonzero d(pc) or d(wy)')
        value = max(e for n, (e, _) in errors.items() if not
                    n.startswith('d'))
        grad_name, (grad, _) = max(
            ((n, e) for n, e in errors.items() if n.startswith('d')),
            key=lambda item: item[1][0])
        lines.append(f'{tag}: values max rel {value:.2e}, gradients max rel '
                     f'{grad:.2e} ({grad_name}); zero-cotangent frames and '
                     'padded rows exactly 0')
  return lines


def numerator_live_rows(torch, num_labels, u1):
  """[B * U1] rows with a cotangent somewhere (numerator_cotangents)."""
  u = torch.arange(u1, device='cuda')[None, :]
  live = u <= num_labels[:, None]
  live[1] = False
  return live.reshape(-1)


def string_cotangents(torch, lattice, semirings, nb, nl, num_frames,
                      num_labels, batch, u1):
  """The cotangents of (nb, nl) [T, B * U1] under the mean -numerator of
  the string DP: what the train step's backward hands the numerator."""
  max_t = nb.shape[0]
  nb = nb.detach().view(max_t, batch, u1).requires_grad_(True)
  nl = nl.detach().view(max_t, batch, u1).requires_grad_(True)
  numerator = lattice._string_dp(nb, nl, num_frames, num_labels,
                                 semirings.Log)
  (-numerator.sum() / batch).backward()
  return (nb.grad.reshape(max_t, -1).contiguous(),
          nl.grad.reshape(max_t, -1).contiguous())


def numerator_inputs(torch, lattice, lattice_params, labels):
  """(cache, states, next_labels) of a HAT lattice's numerator: the
  context cache, each label position's state, and its next label (1 after
  the last, whose weight the string DP never reads)."""
  cache = lattice.build_cache(lattice_params)
  states = lattice.context.walk_states(labels)
  next_labels = torch.cat([labels, torch.ones_like(labels[:, :1])], dim=1)
  return cache, states, next_labels


def staged_numerator(torch, lattice, numerator_scan, lattice_params, frames,
                     labels):
  """The numerator kernels' inputs (pc, pf, head, wy, by), detached, and
  the number of label positions U+1."""
  wf_params = {k: v.detach() for k, v in lattice_params['weight_fn'].items()}
  with torch.no_grad():
    cache, states, next_labels = numerator_inputs(torch, lattice,
                                                  lattice_params, labels)
    pc, pf, wy, by = numerator_scan.stage(lattice.weight_fn.weight_fn,
                                          wf_params, cache, frames, states,
                                          next_labels)
  head = {n: wf_params[n] for n in numerator_scan._HEAD}
  return (pc, pf, head, wy, by), states.shape[1]


def launched_kernels(torch, fn):
  """The names of the device kernels that one call of fn launches, under
  the profiler (``device_spans``)."""
  _, spans = device_spans(torch, fn)
  return {name for _, _, name in spans}


def numerator_alone(torch, numerator_scan, inputs, g, kw, num_frames,
                    num_labels):
  """The numerator kernels alone against their plain versions, timed once
  each with CUDA events. The forward's bound counts the head products of
  every (frame, label position) pair: it has no lengths, and defines every
  output, as JAX's does. The backward's counts those of the live pairs, t
  < num_frames and u <= num_labels, alone: the string DP masks the others,
  their cotangents are zero and the kernel skips them. Checks under the
  profiler that the forward runs its row-reduce product and no head_kernel
  (the design before). Returns (kernel ms, plain ms, errors, flops, bytes,
  dtype) per direction."""
  pc, pf, head, wy, by = inputs
  forward = lambda: numerator_scan.numerator_forward(pc, pf, head, wy, by,
                                                     **kw)
  names = launched_kernels(torch, forward)
  check(any('row_lse_kernel' in n for n in names) and
        not any(re.search(r'(?<!\w)head_kernel', n) for n in names),
        f'the numerator forward launched {sorted(names)}')
  fwd_k, fwd_ms = timed(torch, forward)
  bwd_k, bwd_ms = timed(torch, lambda: numerator_scan.numerator_backward(
      pc, pf, head, wy, by, fwd_k[2], fwd_k[3], *g, **kw))
  fwd_p, plain_fwd_ms = timed(
      torch, lambda: numerator_scan.numerator_forward_plain(
          pc, pf, head, wy, by, **kw))
  bwd_p, plain_bwd_ms = timed(
      torch, lambda: numerator_scan.numerator_backward_plain(
          pc, pf, head, wy, by, fwd_p[2], fwd_p[3], *g, **kw))
  rtols = NUM_RTOL[str(kw['compute_dtype'])[6:]]
  fwd_err = max_errors(torch, fwd_k, fwd_p, NUMERATOR_FORWARD_NAMES, rtols)
  bwd_err = max_errors(torch, bwd_k, bwd_p, NUMERATOR_BACKWARD_NAMES, rtols)
  max_t, batch, hidden = pf.shape
  rows, vocab = pc.shape[0], head['vocab_w'].shape[1]
  live_pairs = int((num_frames.clamp(max=max_t) * (num_labels + 1)).sum())
  all_pairs = max_t * rows
  fwd_flops = 2.0 * all_pairs * hidden * vocab
  bwd_flops = 3 * 2.0 * live_pairs * hidden * vocab
  dtype = str(kw['compute_dtype'])[6:]
  fwd_bytes = (nbytes(pc, pf, wy, by, *head.values()) +
               nbytes(*fwd_k))
  bwd_bytes = (nbytes(pc, pf, wy, by, *head.values(), fwd_k[2], fwd_k[3],
                      *g) + nbytes(*bwd_k))
  return {
      'forward': (fwd_ms, plain_fwd_ms, fwd_err, fwd_flops, fwd_bytes,
                  dtype),
      'backward': (bwd_ms, plain_bwd_ms, bwd_err, bwd_flops, bwd_bytes,
                   dtype),
      'line': (f'numerator kernels alone, {dtype} '
               f'{"hat" if kw["hat"] else "log_softmax"} B={batch} '
               f'T={max_t} R={rows} V={vocab} h={hidden}: forward kernel '
               f'{fwd_ms:.1f} ms (bound '
               f'{bound(fwd_flops, fwd_bytes, dtype)[0]:.1f}, all {all_pairs} '
               f'(frame, position) pairs), plain {plain_fwd_ms:.1f} ms; '
               f'backward kernel {bwd_ms:.1f} ms (bound '
               f'{bound(bwd_flops, bwd_bytes, dtype)[0]:.1f}, {live_pairs} '
               f'live pairs), plain {plain_bwd_ms:.1f} ms; vs plain: '
               + ', '.join(f'{n} {e:.2e}' for n, (e, _) in
                           {**fwd_err, **bwd_err}.items())),
  }


def plain_hat_mean_loss(torch, model, numerator_scan, semirings, params,
                        frames, num_frames, labels, num_labels):
  """``GNATModel.mean_loss`` of a HAT model with the numerator kernels'
  plain versions."""
  lattice = model.lattice
  encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  cache, states, next_labels = numerator_inputs(torch, lattice,
                                                params['lattice'], labels)
  blank, lexical = numerator_scan.label_weights(
      lattice.weight_fn.weight_fn, params['lattice']['weight_fn'], cache,
      encoded, states, next_labels, hat=True,
      forward=numerator_scan.numerator_forward_plain,
      backward=numerator_scan.numerator_backward_plain)
  per_seq = -lattice._string_dp(blank.movedim(-1, 0), lexical.movedim(-1, 0),
                                num_frames, num_labels, semirings.Log)
  finite = torch.isfinite(per_seq)
  return torch.where(finite, per_seq, 0.0).sum() / finite.sum().clamp(min=1)


def phase_hat_training(torch, gnat, presets, numerator_scan, semirings,
                       pytree):
  """Phase 6b: the HAT training main path, hat_bigram(vocab_size=1024):
  3 train steps through the numerator kernels (float32, as GNATModel
  leaves compute_dtype None). Prints its lines; returns the numerator
  kernels' records."""
  config = presets.hat_bigram(vocab_size=1024)
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  rng = np.random.default_rng(0)
  batch_size, max_t = len(NUM_FRAMES), max(NUM_FRAMES)
  frames = torch.from_numpy(
      rand(rng, (batch_size, max_t, config.feature_size))).cuda()
  labels = torch.from_numpy(rng.integers(
      1, config.vocab_size + 1, size=(batch_size, max(NUM_LABELS)))).cuda()
  num_frames = torch.tensor(NUM_FRAMES, device='cuda')
  num_labels = torch.tensor(NUM_LABELS, device='cuda')
  batch = (frames, num_frames, labels, num_labels)
  real_frames = sum(NUM_FRAMES)

  leaves = pytree.tree_leaves(state.params)
  t0 = time.perf_counter()
  loss_k, grads_k = loss_and_grads(
      torch, leaves, lambda: model.mean_loss(state.params, *batch))
  loss_p, grads_p = loss_and_grads(
      torch, leaves, lambda: plain_hat_mean_loss(
          torch, model, numerator_scan, semirings, state.params, *batch))
  loss_rel = abs(loss_k - loss_p) / abs(loss_p)
  check(np.isfinite(loss_k) and loss_rel <= STEP_LOSS_RTOL,
        f'HAT step-1 loss {loss_k} through the kernels, {loss_p} plain')
  paths = [pytree.keystr(path) for path, _ in
           pytree.tree_flatten_with_path(state.params)[0]]
  largest = max(g.abs().max().item() for g in grads_p)
  worst = own = (0.0, '')
  for path, a, b in zip(paths, grads_k, grads_p):
    check(bool(torch.isfinite(a).all()), f'{path}: gradient not finite')
    diff = (a - b).abs().max().item()
    worst = max(worst, (diff / largest, path))
    own = max(own, (diff / max(b.abs().max().item(), 1e-30), path))
  check(own[0] <= HAT_STEP_GRAD_RTOL,
        f'HAT step-1 gradient of {own[1]}: kernel vs plain {own[0]:.3g} of '
        'its own largest entry')
  say('hat-train', f'step 1 through the kernels vs plain versions: loss '
      f'{loss_k:.6g} vs {loss_p:.6g} (rel {loss_rel:.2e}); gradients, '
      f'{len(leaves)} leaves, max |a-b| {worst[0]:.2e} of the largest '
      f'gradient {largest:.3g} ({worst[1]}); of the leaf\'s own scale at '
      f'most {own[0]:.2e} ({own[1]}) ({time.perf_counter() - t0:.1f} s)')

  # The main path: train steps through the kernels, counted and timed.
  losses, step_ms, per_step = [], [], []
  numerator_scan.forward_launches = numerator_scan.backward_launches = 0
  for _ in range(TRAIN_STEPS):
    counts = numerator_scan.forward_launches, numerator_scan.backward_launches
    (state, loss), ms = timed(torch, lambda: gnat.train_step(
        model, optimizer, state, *batch))
    step_ms.append(ms)
    losses.append(loss.item())
    per_step.append((numerator_scan.forward_launches - counts[0],
                     numerator_scan.backward_launches - counts[1]))
  launches = numerator_scan.forward_launches, numerator_scan.backward_launches
  check(model.lattice.last_path is None,
        'the HAT loss ran a log-partition route')
  check(all(f >= 1 and b >= 1 for f, b in per_step),
        f'a HAT train step did not launch both numerator kernels: {per_step}')
  check(all(np.isfinite(losses)) and
        all(b < a for a, b in zip(losses, losses[1:])),
        f'HAT losses not finite and decreasing: {losses}')
  check(abs(losses[0] - loss_k) <= 1e-6 * abs(loss_k),
        f'HAT train step 1 loss {losses[0]} != mean_loss {loss_k}')
  say('hat-train',
      f'hat_bigram B={batch_size} T_max={max_t} U_max={max(NUM_LABELS)}, '
      f'{TRAIN_STEPS} train steps: losses '
      + ', '.join(f'{x:.6g}' for x in losses) + '; step ms '
      + ', '.join(f'{x:.1f}' for x in step_ms) + ' ('
      + ', '.join(f'{real_frames / x * 1e3:.0f}' for x in step_ms)
      + f' real frames/s); numerator launches per step (forward, backward) '
      f'{per_step}')
  say('hat-train', 'one more step under the profiler: ' + device_profile(
      torch, lambda: gnat.train_step(model, optimizer, state, *batch))[1])
  return hat_step_parts(torch, model, optimizer, state, batch, launches,
                        numerator_scan, semirings)


def hat_step_parts(torch, model, optimizer, state, batch, launches,
                   numerator_scan, semirings):
  """The HAT step's parts, each alone: the numerator kernels against their
  plain versions at the step's shapes and cotangents, the encoder, the
  string DP and the optimizer. Returns the kernels' records."""
  frames, num_frames, labels, num_labels = batch
  params = state.params
  lattice = model.lattice
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  inputs, u1 = staged_numerator(torch, lattice, numerator_scan,
                                params['lattice'], encoded, labels)
  batch_size = len(labels)
  kw = dict(hat=True, compute_dtype=torch.float32)
  nb, nl, _, _ = numerator_scan.numerator_forward(*inputs, **kw)
  g = string_cotangents(torch, lattice, semirings, nb, nl, num_frames,
                        num_labels, batch_size, u1)
  alone = numerator_alone(torch, numerator_scan, inputs, g, kw, num_frames,
                          num_labels)
  say('hat-train', alone['line'])

  def encoder_fwd_bwd():
    out = model.encoder.apply(params['encoder'], frames, num_frames)
    out.backward(torch.ones_like(out))

  def string_dp_fwd_bwd():
    string_cotangents(torch, lattice, semirings, nb, nl, num_frames,
                      num_labels, batch_size, u1)

  _, encoder_ms = timed(torch, encoder_fwd_bwd)
  _, dp_ms = timed(torch, string_dp_fwd_bwd)
  _, optimizer_ms = timed(
      torch, lambda: optimizer.apply_gradients(state.opt_state))
  fwd, bwd = alone['forward'], alone['backward']
  say('hat-train', f'step parts alone: encoder forward+backward '
      f'{encoder_ms:.1f} ms, numerator kernels {fwd[0]:.1f} + {bwd[0]:.1f} '
      f'ms, string DP forward+backward {dp_ms:.1f} ms, optimizer update '
      f'{optimizer_ms:.1f} ms')
  records = []
  for name, line_no, (ms, plain_ms, err, flops, traffic, dtype), count in (
      ('numerator_forward', 284, fwd, launches[0]),
      ('numerator_backward', 376, bwd, launches[1])):
    records.append(kernel_record(
        name, 'numerator_scan.cu', f'numerator_scan.py:{line_no}', count,
        max(e[1] for e in err.values()), ms, plain_ms, flops, traffic,
        dtype))
  return records


def phase_hat_headline(torch, lattices, contexts, alignments, weight_fns,
                       numerator_scan, semirings, pytree):
  """Phase 7b: the HAT loss at bench.py's config 7 (hat training at
  headline shapes: B=32, T=1600, U=100, feature=emb=hidden=512, V=1024,
  FLD(2), bfloat16 heads, no encoder) through the numerator kernels, and
  the kernels alone against their plain versions there."""
  vocab, hidden, batch_size, max_t, max_u = 1024, 512, 32, 1600, 100
  lattice = lattices.RecognitionLattice(
      context=contexts.FullNGram(vocab_size=vocab, context_size=1),
      alignment=alignments.FrameLabelDependent(max_expansions=2),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=hidden),
      weight_fn_factory=lambda ctx: weight_fns.LocallyNormalizedWeightFn(
          weight_fns.JointWeightFn(vocab_size=vocab, hidden_size=hidden,
                                   compute_dtype=torch.bfloat16)))
  params = lattice.init(torch.Generator().manual_seed(0), feature_size=hidden,
                        device='cuda')
  leaves = pytree.tree_leaves(params)
  for leaf in leaves:
    leaf.requires_grad_(True)
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(
      rand(rng, (batch_size, max_t, hidden), 0.1)).cuda()
  num_frames = torch.full((batch_size,), max_t, device='cuda')
  labels = torch.from_numpy(
      rng.integers(1, vocab + 1, size=(batch_size, max_u))).cuda()
  num_labels = torch.full((batch_size,), max_u, device='cuda')

  def loss_fwd_bwd():
    loss = lattice.loss(params, frames, num_frames, labels, num_labels)
    loss.sum().backward()
    return loss

  counts = numerator_scan.forward_launches, numerator_scan.backward_launches
  loss, loss_ms = timed(torch, loss_fwd_bwd)
  check((numerator_scan.forward_launches, numerator_scan.backward_launches)
        == (counts[0] + 1, counts[1] + 1),
        'the config-7 HAT loss did not launch both numerator kernels once')
  check(bool(torch.isfinite(loss).all()) and bool((loss > 0).all()),
        'config-7 HAT losses not finite and positive')
  check(all(bool(torch.isfinite(leaf.grad).all()) for leaf in leaves),
        'config-7 HAT gradients not finite')
  say('hat-headline', f'HAT lattice loss forward+backward (bench config 7: '
      f'B={batch_size} T={max_t} U={max_u} feature=emb=hidden={hidden} '
      f'V={vocab} FLD(2), bf16 heads) {loss_ms:.1f} ms '
      f'({batch_size * max_t / loss_ms * 1e3:.0f} frames/s)')
  inputs, u1 = staged_numerator(torch, lattice, numerator_scan, params,
                                frames, labels)
  kw = dict(hat=True, compute_dtype=torch.bfloat16)
  nb, nl, _, _ = numerator_scan.numerator_forward(*inputs, **kw)
  g = string_cotangents(torch, lattice, semirings, nb, nl, num_frames,
                        num_labels, batch_size, u1)
  del nb, nl
  say('hat-headline', numerator_alone(torch, numerator_scan, inputs, g, kw,
                                      num_frames, num_labels)['line'])


def long_rtol(log_z):
  """The tolerance of posteriors and gradients of a long utterance: 8
  float32 roundings of the largest |log Z| (at least bfloat16's 1e-3)."""
  return max(LP_RTOL['bfloat16'][1],
             LP_LONG_ROUNDINGS * 2.0**-24 * log_z.abs().max().item())


def blank_drift(torch, bm, num_frames):
  """max over valid frames of |log(sum of the frame's blank posteriors)|:
  0 in exact arithmetic for FLD, where every path takes one blank arc per
  frame."""
  valid = (torch.arange(bm.shape[1], device='cuda')[None, :] <
           num_frames[:, None])
  return bm.double().sum(-1)[valid].log().abs().max().item()


def posterior_checks(torch, bm, lp, num_frames, k, drift, tol):
  """Checks FLD(k) posteriors [B, T, S] / [B, T, V]: padding frames 0, all
  >= 0, each valid frame's blank posteriors summing to 1 within a factor
  exp(drift), and its label posteriors to at most k times its blank
  posteriors' sum (up to k labels and one blank per path; the two sums
  carry the frame's log-space rounding alike), within tol. Returns (blank
  drift, largest label sum over blank sum)."""
  valid = (torch.arange(bm.shape[1], device='cuda')[None, :] <
           num_frames[:, None])
  check(not bool(bm[~valid].any()) and not bool(lp[~valid].any()),
        'padding frames have nonzero posteriors')
  check(bool((bm >= 0).all()) and bool((lp >= 0).all()),
        'negative posteriors')
  measured = blank_drift(torch, bm, num_frames)
  check(measured <= drift, f'a valid frame\'s blank posteriors sum to '
        f'exp(+-{measured:.3g}) (> exp({drift:.3g}))')
  ratio = (lp.double().sum(-1)[valid] /
           bm.double().sum(-1)[valid]).max().item()
  check(ratio <= k * (1 + tol),
        f'a frame\'s label posteriors sum to {ratio} > {k} blank sums')
  return measured, ratio


def staged_lattice_inputs(torch, lattice, lattice_params, encoded):
  """(cache, pf, pc, head) of a bigram lattice as the kernels take them."""
  wf_params = lattice_params['weight_fn']
  with torch.no_grad():
    cache = lattice.build_cache(lattice_params)
    pf = torch.einsum('btf,fh->tbh', encoded,
                      wf_params['frame_proj']).contiguous()
    pc = (cache @ wf_params['context_proj']).contiguous()
  head = {n: wf_params[n].detach() for n in
          ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  return cache, pf, pc, head


def phase_confidence(torch, gnat, presets, fused_scan, joint_head, modules):
  """Phase 8: the confidence main path. gnat_global_bigram at full width
  with phase 4's weights and requests: encoder, then
  ``RecognitionLattice.label_marginals`` through the forward and marginals
  kernels, counted and timed; against the same call through the plain
  versions on the card; the kernels alone; ``arc_marginals``' guard at this
  size and its agreement with label_marginals at B=2, T=100 (the generic
  route, whose 1025-state apply launches the joint+head forward kernel).
  Prints its lines; returns the marginals kernel's record and the
  joint+head forward launches of arc_marginals."""
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  params = model.init(torch.Generator().manual_seed(0))
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(
      rand(rng, (len(NUM_FRAMES), max(NUM_FRAMES), config.feature_size))
  ).cuda()
  num_frames = torch.tensor(NUM_FRAMES, device='cuda')
  lattice, lattice_params = model.lattice, params['lattice']
  k = config.max_expansions

  @torch.no_grad()
  def confidence():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    return lattice.label_marginals(lattice_params, encoded, num_frames)

  confidence()  # warm-up
  torch.cuda.synchronize()
  reset_counts(*modules)
  (bm, lp), path_ms = timed(torch, confidence)
  launches = counts(fused_scan)
  check(launches['forward_launches'] >= 1 and
        launches['marginals_launches'] >= 1,
        f'the confidence path did not launch the forward and marginals '
        f'kernels: {launches}')
  check(lattice.last_path == 'kernel',
        f'last_path is {lattice.last_path!r}, not kernel')
  check(tuple(bm.shape) == (8, 1600, 1025) and
        tuple(lp.shape) == (8, 1600, 1024), 'posteriors of the wrong shape')

  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  cache, pf, pc, head = staged_lattice_inputs(torch, lattice, lattice_params,
                                              encoded)
  is_pad = padding(torch, num_frames, frames.shape[1])
  kw = dict(max_expansions=k, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  # The kernels alone, and the marginals' plain version on the same
  # residuals (these launches are not counted).
  fwd, fwd_ms = timed(torch, lambda: fused_scan.fused_forward(
      pf, pc, head, is_pad, with_residuals=True, **kw))
  residuals = (fwd[0], fwd[2], fwd[3])
  marginals = lambda: fused_scan.fused_marginals(pf, pc, head, is_pad,
                                                 *residuals, **kw)
  got, marg_ms = timed(torch, marginals)
  # The bfloat16 route: the backward's row reductions, the last in its
  # marginals mode, and no marginal_kernel (the design before).
  names = launched_kernels(torch, marginals)
  check(any('lex_pass_kernel' in n and 'true' in n for n in names) and
        not any('marginal_kernel' in n for n in names),
        f'the bfloat16 marginals launched {sorted(names)}')
  want, marg_plain_ms = timed(torch, lambda: fused_scan.fused_marginals_plain(
      pf, pc, head, is_pad, *residuals, **kw))
  tol = long_rtol(fwd[0])
  errors = max_errors(torch, got, want, MARGINALS_NAMES, (BF16_RTOL, tol))
  # The whole call through the plain versions on the card.
  (bm_p, lp_p), plain_path_ms = timed(
      torch, lambda: fused_scan.label_marginals(
          lattice_params['weight_fn'], cache, encoded, num_frames, **kw,
          forward=fused_scan.fused_forward_plain,
          marginals=fused_scan.fused_marginals_plain))
  path_err = max_errors(torch, (bm, lp), (bm_p, lp_p), MARGINALS_NAMES,
                        (BF16_RTOL, tol))
  # Structure. In float32 at |log Z| ~ 2e4 every frame's posteriors carry
  # the log-space rounding accumulated over the frames before and after it
  # (PERF.md), in the kernel and the plain version alike; a float64
  # reference of the same rounded products (the plain versions in float64,
  # on the two longest requests) has the exact structure. The kernel's
  # blank sums may drift from 1 by at most twice the float32 plain
  # version's drift.
  plain_drift = blank_drift(torch, bm_p, num_frames)
  drift, ratio = posterior_checks(torch, bm, lp, num_frames, k,
                                  2 * plain_drift + tol, tol)
  rows = slice(0, 2)
  bm_64, lp_64 = fused_scan.label_marginals(
      {n: x.double() for n, x in lattice_params['weight_fn'].items()},
      cache.double(), encoded[rows].double(), num_frames[rows], **kw,
      forward=fused_scan.fused_forward_plain,
      marginals=fused_scan.fused_marginals_plain)
  drift_64, ratio_64 = posterior_checks(torch, bm_64, lp_64, num_frames[rows],
                                        k, 1e-6, 1e-6)
  vs_64 = [((a[rows].double() - b).abs().max() / b.abs().max()).item()
           for a, b in ((bm, bm_64), (lp, lp_64))]
  real_rows = sum(NUM_FRAMES)
  flops = 2.0 * real_rows * pc.shape[0] * head['vocab_w'].numel()
  traffic = nbytes(pf, pc, *head.values(), is_pad, *residuals) + nbytes(*got)
  say('confidence',
      f'gnat_global_bigram B=8 T_max=1600 encoder + label_marginals through '
      f'the kernels {path_ms:.1f} ms ({real_rows / path_ms * 1e3:.0f} real '
      f'frames/s), launches {launches}; through the plain versions '
      f'{plain_path_ms:.1f} ms; vs plain (|log Z| up to '
      f'{fwd[0].abs().max().item():.4g}, rtol {tol:.2e}): bm '
      f'{path_err["bm"][0]:.2e}, lp {path_err["lp"][0]:.2e}; padding 0; '
      f'blank sums within exp(+-{drift:.3g}) of 1 (float32 plain '
      f'{plain_drift:.3g}, float64 reference on rows 0-1 {drift_64:.2e}), '
      f'label sums at most {ratio:.4f} blank sums (float64 '
      f'{ratio_64:.4f}); kernel vs float64 reference on rows 0-1: bm '
      f'{vs_64[0]:.2e}, lp {vs_64[1]:.2e}')
  say('confidence',
      f'kernels alone, bf16 B=8 T=1600 S=1025 V=1024 h=512 FLD(2): forward '
      f'{fwd_ms:.1f} ms, marginals {marg_ms:.1f} ms (bound '
      f'{bound(flops, traffic, "bfloat16")[0]:.1f} ms, one product a '
      f'frame-row; {bound(k * flops, traffic, "bfloat16")[0]:.1f} ms for the '
      f'{k} products a frame-row that recomputing lex runs), marginals plain '
      f'{marg_plain_ms:.1f} ms; marginals vs plain on the same residuals: '
      f'bm {errors["bm"][0]:.2e}, lp {errors["lp"][0]:.2e}')

  # arc_marginals: the dense output's guard at this size, and at B=2,
  # T=100 its state sums against the float32 plain label_marginals.
  try:
    lattice.arc_marginals(lattice_params, encoded, num_frames)
  except ValueError as e:
    guard = str(e).split(' (>')[0]
  else:
    raise SmokeFailure('arc_marginals at B=8 T=1600 did not raise its guard')
  small = encoded[:2, :100].contiguous()
  small_frames = num_frames[:2].clamp(max=100)
  reset_counts(joint_head)
  (bm_a, lm_a), arc_ms = timed(torch, lambda: lattice.arc_marginals(
      lattice_params, small, small_frames))
  check(lattice.last_path == 'generic', 'arc_marginals left the generic '
        'route')
  # The forward loop and the backward loop each run every frame's apply.
  arc_launches = counts(joint_head)
  check(arc_launches == {'forward_launches': 2 * small.shape[1],
                         'backward_launches': 0},
        f'arc_marginals launched the joint+head kernels {arc_launches}, not '
        f'{2 * small.shape[1]} forwards')
  f32 = dict(kw, compute_dtype=torch.float32)
  plain = dict(forward=fused_scan.fused_forward_plain,
               marginals=fused_scan.fused_marginals_plain)
  bm_f, lp_f = fused_scan.label_marginals(
      lattice_params['weight_fn'], cache, small, small_frames, **f32, **plain)
  log_z_small = fused_scan.fused_forward_plain(
      pf[:100, :2].contiguous(), pc, head, is_pad[:100, :2].contiguous(),
      with_residuals=False, **f32)[0]
  arc_rtol = max(1e-4, LP_LONG_ROUNDINGS * 2.0**-24 *
                 log_z_small.abs().max().item())
  arc_err = max_errors(torch, (bm_a, lm_a.sum(-2)), (bm_f, lp_f),
                       MARGINALS_NAMES, (F32_RTOL, arc_rtol))
  say('confidence',
      f'arc_marginals: {guard}, raised; at B=2 T=100 (generic route, '
      f'float32) {arc_ms:.1f} ms, joint+head forward kernel launches '
      f'{arc_launches["forward_launches"]}; its state sums vs the float32 '
      f'plain label_marginals (|log Z| up to '
      f'{log_z_small.abs().max().item():.4g}, rtol {arc_rtol:.1e}): bm '
      f'{arc_err["bm"][0]:.2e}, lp {arc_err["lp"][0]:.2e}')
  return kernel_record(
      'fused_marginals', 'fused_scan.cu', 'fused_scan.py:527',
      launches['marginals_launches'], max(e[1] for e in errors.values()),
      marg_ms, marg_plain_ms, flops, traffic,
      'bfloat16'), arc_launches['forward_launches']


def phase_confidence_headline(torch, lattices, contexts, alignments,
                              weight_fns, fused_scan):
  """Phase 8b: label_marginals at bench.py's config 8 (the headline lattice
  of bench_headline: B=32, T=1600, FLD(2), feature 512, bf16) through the
  kernels, and the kernels alone; the plain versions are skipped here."""
  batch_size, max_t = 32, 1600
  lattice, params = bench_lattice(torch, lattices, contexts, alignments,
                                  weight_fns, 1024)
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(rand(rng, (batch_size, max_t, 512), 0.1)).cuda()
  num_frames = torch.full((batch_size,), max_t, device='cuda')
  before = fused_scan.forward_launches, fused_scan.marginals_launches
  (bm, lp), ms = timed(torch, lambda: lattice.label_marginals(
      params, frames, num_frames))
  check((fused_scan.forward_launches, fused_scan.marginals_launches) ==
        (before[0] + 1, before[1] + 1),
        'config 8 did not launch the forward and marginals kernels once')
  check(lattice.last_path == 'kernel', 'config 8 left the kernels')
  _, pf, pc, head = staged_lattice_inputs(torch, lattice, params, frames)
  is_pad = padding(torch, num_frames, max_t)
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  fwd, fwd_ms = timed(torch, lambda: fused_scan.fused_forward(
      pf, pc, head, is_pad, with_residuals=True, **kw))
  got, marg_ms = timed(torch, lambda: fused_scan.fused_marginals(
      pf, pc, head, is_pad, fwd[0], fwd[2], fwd[3], **kw))
  tol = long_rtol(fwd[0])
  # No plain run here: the blank sums' drift is held to its worst case, one
  # float32 rounding of |log Z| per frame, accumulated over the frames.
  worst = max_t * 2.0**-24 * fwd[0].abs().max().item()
  drift, ratio = posterior_checks(torch, bm, lp, num_frames, 2, worst, tol)
  flops = 2.0 * batch_size * max_t * pc.shape[0] * head['vocab_w'].numel()
  traffic = (nbytes(pf, pc, *head.values(), is_pad, fwd[0], fwd[2], fwd[3])
             + nbytes(*got))
  say('confidence-headline',
      f'label_marginals (bench config 8: B={batch_size} T={max_t} S=1025 '
      f'V=1024 h=512 FLD(2), bf16) {ms:.1f} ms '
      f'({batch_size * max_t / ms * 1e3:.0f} frames/s); kernels alone: '
      f'forward {fwd_ms:.1f} ms, marginals {marg_ms:.1f} ms (bound '
      f'{bound(flops, traffic, "bfloat16")[0]:.1f} ms, one product a '
      f'frame-row; {bound(2 * flops, traffic, "bfloat16")[0]:.1f} ms for '
      f'two); blank sums within '
      f'exp(+-{drift:.3g}) of 1 (worst case exp(+-{worst:.3g})), label sums '
      f'at most {ratio:.4f} blank sums')


def phase_large_vocab(torch, gnat, presets, fused_scan, semirings, pytree,
                      viterbi):
  """Phase 9: the large-vocabulary main path,
  gnat_global_bigram(vocab_size=4096) at full width: 3 train steps on 8
  utterances of phase 6's lengths / 8 with one label per 4 frames (bench
  config 9's rate), step 1 against the plain versions; then a decode of
  the same utterances through the Viterbi kernel (bench config 10's
  path), checked as phase 4's, and the Viterbi forward and backtrace alone
  on its inputs. Returns (mode, (forward, backward) launches, Viterbi
  launches, the Viterbi forward's ms alone)."""
  config = presets.gnat_global_bigram(vocab_size=4096)
  num_frames_list = [n // 8 for n in NUM_FRAMES]
  num_labels_list = [n // 4 for n in num_frames_list]
  route = bigram_route(torch, fused_scan, config, len(num_frames_list))
  mode = route['name']
  model, _, state, batch, launches = train_and_check(
      torch, gnat, semirings, pytree, config, num_frames_list,
      num_labels_list, 'large-vocab', route)
  frames, num_frames = batch[:2]
  params = state.params
  decode = lambda: model.decode(params, frames, num_frames)
  decode()  # warm-up
  torch.cuda.synchronize()
  viterbi.launches = 0
  (labels, num_labels, weights), decode_ms = timed(torch, decode)
  viterbi_launches = viterbi.launches
  check(viterbi_launches >= 1, 'the V=4096 decode did not launch the '
        'Viterbi kernel')
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  num_align = config.max_expansions + 1
  check(torch.equal(num_labels, num_align * num_frames.int()),
        'num_alignment_labels != 3 * num_frames')
  check(int(labels.min()) >= 0 and int(labels.max()) <= config.vocab_size,
        'labels outside [0, V]')
  slot = torch.arange(labels.shape[1], device='cuda')[None]
  check(not bool(labels[slot >= num_labels[:, None]].any()),
        'padding slots are not blank')
  check(bool(torch.isfinite(weights).all()), 'path weights not finite')
  bigram = dict(max_expansions=config.max_expansions, frame_dependent=False)
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    _, pf, pc, head = staged_lattice_inputs(torch, model.lattice,
                                            params['lattice'], encoded)
    wf_params = {n: x.detach() for n, x in
                 params['lattice']['weight_fn'].items()}
    cache = model.lattice.build_cache(params['lattice'])
    plain_out, plain_ms = timed(torch, lambda: viterbi.viterbi_decode(
        wf_params, cache, encoded, num_frames, **bigram,
        compute_dtype=torch.bfloat16, forward=viterbi.viterbi_forward_plain))
    rescored = rescore(torch, labels, num_frames, pf, pc, head, **bigram,
                       compute_dtype=torch.bfloat16)
  report = compare_decodes(torch, (labels, num_labels, weights), plain_out,
                           rescored, torch.bfloat16)
  real_frames = sum(num_frames_list)
  say('large-vocab', f'decode of the same utterances through the Viterbi '
      f'kernel (S=4097 V=4096): {decode_ms:.1f} ms '
      f'({real_frames / decode_ms * 1e3:.0f} real frames/s), plain '
      f'{plain_ms:.1f} ms, launches {viterbi_launches}; vs plain: {report}')
  # The Viterbi forward and the backtrace alone on the decode's inputs
  # (outside the counted run).
  is_pad = padding(torch, num_frames, frames.shape[1])
  fwd = dict(**bigram, compute_dtype=torch.bfloat16)
  viterbi.viterbi_forward(pf, pc, head, is_pad, **fwd)  # warm-up
  forward_out, forward_ms = timed(
      torch, lambda: viterbi.viterbi_forward(pf, pc, head, is_pad, **fwd),
      repeats=3)
  _, backtrace_ms = timed(
      torch, lambda: viterbi.backtrace(*forward_out, is_pad, **bigram),
      repeats=3)
  # Its bound: one [S, h] x [h, V] product per real frame-row.
  flops = 2.0 * real_frames * pc.shape[0] * head['vocab_w'].numel()
  traffic = nbytes(pf, pc, *head.values(), is_pad, *forward_out)
  say('large-vocab', f'viterbi_forward bf16 B=8 T_max={frames.shape[1]} '
      f'S=4097 V=4096 h=512 alone: {forward_ms:.1f} ms (bound '
      f'{bound(flops, traffic, "bfloat16")[0]:.1f} ms); '
      + decode_split(decode_ms, forward_ms, backtrace_ms))
  return mode, launches, viterbi_launches, forward_ms


def phase_config9(torch, lattices, contexts, alignments, weight_fns,
                  fused_scan, modules, large_vocab):
  """Phase 9b: bench.py's config 9 alone (V=4096, B=8, T=200, FLD(2),
  feature=emb=hidden=512, bf16): log Z and its gradients through
  ``log_partition(mode='online')``, counted; then each mode's kernels
  alone against the plain versions, timed, with their peak device memory
  (the pair's and the backward's; the online backward's must stay below
  the cache one's). ``large_vocab`` is phase 9's (mode, launches). Returns
  the online kernels' records."""
  vocab, batch_size, max_t = 4096, 8, 200
  lattice, params = bench_lattice(torch, lattices, contexts, alignments,
                                  weight_fns, vocab)
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(rand(rng, (batch_size, max_t, 512), 0.1)).cuda()
  num_frames = torch.full((batch_size,), max_t, device='cuda')
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  leaves = [x for group in params.values() for x in group.values()]
  for leaf in leaves:
    leaf.requires_grad_(True)

  def online_path():
    log_z = fused_scan.log_partition(
        params['weight_fn'], lattice.build_cache(params), frames, num_frames,
        mode='online', **kw)
    log_z.sum().backward()
    return log_z

  reset_counts(*modules)
  log_z, path_ms = timed(torch, online_path)
  launches = counts(fused_scan)
  check(launches['online_forward_launches'] == 1 and
        launches['online_backward_launches'] == 1 and
        launches['forward_launches'] == launches['backward_launches'] == 0,
        f'log_partition(mode=\'online\') launched {launches}')
  check(bool(torch.isfinite(log_z).all()) and
        all(bool(torch.isfinite(x.grad).all()) for x in leaves),
        'config 9: log Z or its gradients not finite')
  auto = fused_scan.plan(batch_size, vocab + 1, vocab, torch.bfloat16)
  say('config9', f'log_partition(mode=\'online\') forward+backward (bench '
      f'config 9: B={batch_size} T={max_t} S=4097 V={vocab} h=512 FLD(2), '
      f'bf16) {path_ms:.1f} ms ({batch_size * max_t / path_ms * 1e3:.0f} '
      f'frames/s), launches {launches}; \'auto\' plans {auto!r} here')
  _, pf, pc, head = staged_lattice_inputs(torch, lattice, params, frames)
  is_pad = padding(torch, num_frames, max_t)
  g = torch.ones((batch_size,), device='cuda')
  del log_z
  for leaf in leaves:
    leaf.grad = None
  # Online launches by path: this phase's, and phase 9's train steps when
  # 'auto' planned the online mode there.
  train_mode, train_launches = large_vocab
  by_path = [{'config 9 log_partition(mode=\'online\')': launches[name],
              'gnat_global_bigram(vocab_size=4096) train steps':
                  count if train_mode == 'online' else 0}
             for name, count in zip(LP_COUNTERS['online'], train_launches)]
  cache_rec = kernels_alone(torch, bigram_kernels(fused_scan, 'cache'), pf, pc,
                            head, is_pad, g, kw, (None, None))
  say('config9', cache_rec['line'])
  online_rec = kernels_alone(
      torch, bigram_kernels(fused_scan, 'online'), pf, pc, head, is_pad, g,
      kw, tuple(sum(paths.values()) for paths in by_path),
      plain=cache_rec.pop('plain'))
  say('config9', online_rec['line'])
  peak_mib = {mode: rec['peak'] / 2**20 for mode, rec in
              (('cache', cache_rec), ('online', online_rec))}
  backward_peak_mib = {mode: rec['backward_peak'] / 2**20 for mode, rec in
                       (('cache', cache_rec), ('online', online_rec))}
  forward_peak_mib = {mode: rec['forward_peak'] / 2**20 for mode, rec in
                      (('cache', cache_rec), ('online', online_rec))}
  check(backward_peak_mib['online'] < backward_peak_mib['cache'],
        f'config 9: the online backward\'s peak memory '
        f'{backward_peak_mib["online"]:.0f} MiB is not below the cache '
        f'mode\'s {backward_peak_mib["cache"]:.0f} MiB')
  check(forward_peak_mib['online'] < forward_peak_mib['cache'],
        f'config 9: the online forward\'s peak memory '
        f'{forward_peak_mib["online"]:.0f} MiB is not below the cache '
        f'mode\'s {forward_peak_mib["cache"]:.0f} MiB')
  say('config9', 'forward peak device memory: ' + ', '.join(
      f'{mode} {mib:.0f} MiB' for mode, mib in forward_peak_mib.items()) +
      '; backward peak device memory: ' + ', '.join(
      f'{mode} {mib:.0f} MiB' for mode, mib in backward_peak_mib.items()) +
      f'; online / cache backward time '
      f'{online_rec["backward"]["ms"] / cache_rec["backward"]["ms"]:.3f}')
  return [dict(online_rec[key], launches_by_path=paths,
               cache_mode_ms=cache_rec[key]['ms'], peak_mib=peak_mib,
               forward_peak_mib=forward_peak_mib,
               backward_peak_mib=backward_peak_mib)
          for key, paths in zip(('forward', 'backward'), by_path)]


def phase_trigram_vs_plain(torch, contexts, trigram_scan):
  """Phase 5e: the trigram log-partition kernels against their plain
  versions: T=64, B=4, V=64 (S=4161) and a ragged V=50 (S=2551), FD /
  FLD(1) / FLD(2), float32 and bfloat16, and in bfloat16 FLD(0) at V=64
  and FLD(2) at V=130 (S=17031), which the tile kernels run (the segment
  kernels run the other bfloat16 cases: checked), with phase 5's
  zero-cotangent and empty rows."""
  rng = np.random.default_rng(9)
  is_pad = padding(torch, LP_NUM_FRAMES, 64)
  g = torch.tensor(LP_G, device='cuda')
  lines = []
  # Both types of every alignment at V=64 and 50, then two bfloat16 cases
  # that the segment kernels leave to the first design's tile kernels:
  # FLD(0) and V=130.
  cases = [(vocab, *alignment, dtype) for vocab in (64, 50)
           for alignment in ALIGNMENT_CASES
           for dtype in (torch.float32, torch.bfloat16)]
  tile_cases = [(64, 'FLD(0)', 0, False, torch.bfloat16),
                (130, 'FLD(2)', 2, False, torch.bfloat16)]
  inputs = {}
  for case in cases + tile_cases:
    vocab, name, k, fd, dtype = case
    if vocab not in inputs:
      inputs[vocab] = lp_inputs(torch, rng, vocab, states=contexts.FullNGram(
          vocab_size=vocab, context_size=2).num_states())
    pf, pc, params = inputs[vocab]
    segments = trigram_scan.segment_route(
        pf.shape[1], vocab, pf.shape[2], dtype, 1 if fd else k) is not None
    check(segments == (dtype == torch.bfloat16 and case not in tile_cases),
          f'trigram V={vocab} {name} {dtype}: segment route {segments}')
    kw = dict(max_expansions=k, frame_dependent=fd, compute_dtype=dtype)
    tag = (f'V={vocab} S={pc.shape[0]} {name} {str(dtype)[6:]} '
           f'({"segments" if segments else "tiles"})')
    fwd_k = trigram_scan.trigram_forward(pf, pc, params, is_pad,
                                         with_residuals=True, **kw)
    fwd_p = trigram_scan.trigram_forward_plain(pf, pc, params, is_pad,
                                               with_residuals=True, **kw)
    bwd_k = trigram_scan.trigram_backward(pf, pc, params, is_pad,
                                          fwd_k[0], g, fwd_k[2],
                                          fwd_k[3], **kw)
    bwd_p = trigram_scan.trigram_backward_plain(pf, pc, params, is_pad,
                                                fwd_p[0], g, fwd_p[2],
                                                fwd_p[3], **kw)
    torch.cuda.synchronize()
    rtols = LP_RTOL[str(dtype)[6:]]
    try:
      errors = max_errors(torch, fwd_k, fwd_p, FORWARD_NAMES, rtols)
      errors.update(max_errors(torch, bwd_k, bwd_p, BACKWARD_NAMES,
                               rtols))
    except SmokeFailure as e:
      raise SmokeFailure(f'trigram {tag}: {e}') from None
    dpf, beta_out = bwd_k[0], bwd_k[-1]
    check(fwd_k[0][2].item() == 0.0 and bool((beta_out[2] == 0).all()),
          f'trigram {tag}: the empty row has log Z or beta_out != 0')
    check(not bool(dpf[:, 1:3].any()),
          f'trigram {tag}: the g = 0 row or the empty row has nonzero '
          'd(pf)')
    value = max(e for n, (e, _) in errors.items() if n in
                ('log_z', 'alpha', 'hist', 'slabs', 'beta_out'))
    grad_name, (grad, _) = max(
        ((n, e) for n, e in errors.items() if n.startswith('d')),
        key=lambda item: item[1][0])
    lines.append(f'{tag}: values max rel {value:.2e}, gradients max rel '
                 f'{grad:.2e} ({grad_name}); g=0 and empty rows exactly 0')
  return lines


# Phase 10's utterances: phase 6's lengths / 8 (1033 real frames), one
# label per 4 frames.
TRIGRAM_NUM_FRAMES = [n // 8 for n in NUM_FRAMES]
TRIGRAM_NUM_LABELS = [n // 4 for n in TRIGRAM_NUM_FRAMES]
# Phase 10's float32 generic decode against the same route in float64.
F64_DECODE_RTOL = 1e-5


def phase_trigram(torch, gnat, presets, fused_scan, trigram_scan, joint_head,
                  semirings, pytree, modules):
  """Phase 10: the trigram main path,
  gnat_global_bigram(vocab_size=64, context_size=2) at full width (S=4161,
  FLD(2)): 3 train steps through the trigram kernels, step 1 against the
  plain versions, one step profiled; the kernels alone at the step's
  shapes; a decode of the same utterances on the generic route, rescored in
  float64 along its trigram state walk and held to the same route in
  float64; label_marginals (generic route), their structure checked. The
  generic route's 4161-state apply launches the joint+head forward kernel
  (float32: the preset's compute type), counted. Returns the trigram
  kernels' records and the joint+head forward launches of the decode and
  of label_marginals."""
  config = presets.gnat_global_bigram(vocab_size=64, context_size=2)
  model, _, state, batch, launches = train_and_check(
      torch, gnat, semirings, pytree, config, TRIGRAM_NUM_FRAMES,
      TRIGRAM_NUM_LABELS, 'trigram', trigram_route(fused_scan, trigram_scan))
  frames, num_frames = batch[:2]
  batch_size, max_t = frames.shape[:2]
  params = state.params
  lattice, lattice_params = model.lattice, params['lattice']
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  cache, pf, pc, head = staged_lattice_inputs(torch, lattice, lattice_params,
                                              encoded)
  is_pad = padding(torch, num_frames, max_t)
  g = torch.full((batch_size,), 1.0 / batch_size, device='cuda')
  kw = dict(max_expansions=config.max_expansions, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  records = kernels_alone(torch, trigram_kernels(trigram_scan), pf, pc, head,
                          is_pad, g, kw, launches, float64_reference=True)
  records.pop('plain')
  say('trigram', records.pop('line'))
  for key, call in trigram_calls(trigram_scan, pf, pc, head, is_pad, g,
                                 kw).items():
    check_segment_route(launched_kernels(torch, call), key,
                        "phase 10's shapes")

  # Serving: GNATModel.decode on the generic route, which launches no
  # kernel; then the tropical forward alone, without the mask's gradient.
  decode = lambda: model.decode(params, frames, num_frames)
  decode()  # warm-up
  torch.cuda.synchronize()
  reset_counts(*modules, joint_head)
  (labels, num_labels, weights), decode_ms = timed(torch, decode)
  check(lattice.last_path == 'generic',
        f'the trigram decode took {lattice.last_path!r}, not generic')
  check(not any(v for m in modules for v in counts(m).values()),
        'the generic decode launched a lattice kernel')
  # The tropical forward, then the checkpoint's recompute of every frame in
  # the mask's gradient: 2 T_max forwards, no backward (the parameters are
  # detached).
  decode_launches = counts(joint_head)
  check(decode_launches == {'forward_launches': 2 * max_t,
                            'backward_launches': 0},
        f'the generic decode launched the joint+head kernels '
        f'{decode_launches}, not {2 * max_t} forwards')
  num_align = config.max_expansions + 1
  check(torch.equal(num_labels, num_align * num_frames.int()),
        'num_alignment_labels != 3 * num_frames')
  check(int(labels.min()) >= 0 and int(labels.max()) <= config.vocab_size,
        'labels outside [0, V]')
  slot = torch.arange(labels.shape[1], device='cuda')[None]
  check(not bool(labels[slot >= num_labels[:, None]].any()),
        'padding slots are not blank')
  check(bool(torch.isfinite(weights).all()), 'path weights not finite')
  with torch.no_grad():
    best, forward_ms = timed(torch, lambda: lattice.shortest_distance(
        lattice_params, encoded, num_frames, semiring=semirings.MaxTropical,
        cache=cache))
  best_rel = relative(torch, weights, best).max().item()
  check(best_rel <= F32_RTOL, f'decode path weights differ from the '
        f'tropical shortest distance by {best_rel:.3g}')
  # Each alignment rescored in float64 along its FullNGram(2) state walk.
  with torch.no_grad():
    rescored = rescore(torch, labels, num_frames, pf, pc, head,
                       max_expansions=config.max_expansions,
                       frame_dependent=False, compute_dtype=torch.float32,
                       context=lattice.context)
  rescored_rel = relative(torch, rescored, weights).max().item()
  check(rescored_rel <= BF16_RTOL, f'a decoded alignment rescores '
        f'{rescored_rel:.3g} relative from its path weight')
  # The same route in float64.
  params_64 = pytree.tree_map(lambda x: x.detach().double(), lattice_params)
  with torch.no_grad():
    (labels_64, num_64, weights_64), decode_64_ms = timed(
        torch, lambda: lattice.shortest_path(params_64, encoded.double(),
                                             num_frames))
  rel_64 = relative(torch, weights, weights_64).max().item()
  check(torch.equal(num_labels, num_64) and rel_64 <= F64_DECODE_RTOL,
        f'float32 decode weights {rel_64:.3g} relative from float64')
  real_slots = slot < num_labels[:, None]
  agreement = 1.0 - int(((labels != labels_64) & real_slots).sum()) / int(
      real_slots.sum())
  check(agreement >= BF16_MIN_SLOT_AGREEMENT,
        f'float32 and float64 decodes agree on {agreement:.5f} of the slots')
  real_frames = sum(TRIGRAM_NUM_FRAMES)
  say('trigram', f'decode (generic route, float32) B={batch_size} '
      f'T_max={max_t} S={pc.shape[0]}: {decode_ms:.1f} ms '
      f'({real_frames / decode_ms * 1e3:.0f} real frames/s, no lattice kernel '
      f'launched, joint+head forward kernel launches '
      f'{decode_launches["forward_launches"]}); the tropical forward alone (no mask gradient, no '
      f'checkpoint recompute) {forward_ms:.1f} ms; vs it {best_rel:.2e}; '
      f'rescored in float64 along the trigram state walk {rescored_rel:.2e}; '
      f'float64 route {decode_64_ms:.1f} ms, weights {rel_64:.2e}, slot '
      f'agreement {agreement:.5f} of {int(real_slots.sum())}')

  # Label posteriors on the generic route.
  with torch.no_grad():
    reset_counts(joint_head)
    (bm, lp), marg_ms = timed(torch, lambda: lattice.label_marginals(
        lattice_params, encoded, num_frames, cache=cache))
    check(lattice.last_path == 'generic',
          'trigram label_marginals left the generic route')
    marg_launches = counts(joint_head)
    check(marg_launches == {'forward_launches': 2 * max_t,
                            'backward_launches': 0},
          f'the generic label_marginals launched the joint+head kernels '
          f'{marg_launches}, not {2 * max_t} forwards')
    log_z = lattice._forward(lattice_params, cache, encoded, num_frames,
                             semirings.Log)[0]
  check(tuple(bm.shape) == (batch_size, max_t, pc.shape[0]) and
        tuple(lp.shape) == (batch_size, max_t, config.vocab_size),
        'trigram posteriors of the wrong shape')
  worst = max_t * 2.0**-24 * log_z.abs().max().item()
  drift, ratio = posterior_checks(torch, bm, lp, num_frames,
                                  config.max_expansions, worst,
                                  long_rtol(log_z))
  say('trigram', f'label_marginals (generic route, float32) {marg_ms:.1f} '
      f'ms, joint+head forward kernel launches '
      f'{marg_launches["forward_launches"]}; blank sums within '
      f'exp(+-{drift:.3g}) of 1 (worst case exp(+-{worst:.3g})), label sums '
      f'at most {ratio:.4f} blank sums; padding 0')
  return records, {'trigram decode': decode_launches['forward_launches'],
                   'trigram label_marginals':
                       marg_launches['forward_launches']}


# The bfloat16 trigram route by segment, per direction, and the first
# design's kernels, which must not run beside it.
SEGMENT_KERNELS = {'forward': ('segments::head_kernel',),
                   'backward': ('segments::head_kernel',
                                'segments::grad_kernel')}
TILE_TRIGRAM_KERNELS = ('joint_blank_kernel', 'lex_kernel',
                        'joint_grad_kernel')


def trigram_calls(trigram_scan, pf, pc, head, is_pad, g, kw):
  """{'forward': fn, 'backward': fn}: one trigram forward with residuals,
  and one backward on the residuals of a forward run here."""
  log_z, _, hist, slabs = trigram_scan.trigram_forward(
      pf, pc, head, is_pad, with_residuals=True, **kw)
  return {'forward': lambda: trigram_scan.trigram_forward(
              pf, pc, head, is_pad, with_residuals=True, **kw),
          'backward': lambda: trigram_scan.trigram_backward(
              pf, pc, head, is_pad, log_z, g, hist, slabs, **kw)}


def check_segment_route(names, key, where):
  """Checks that the device kernels ``names`` of one bfloat16 trigram
  ``key`` ('forward' or 'backward') call are the segment kernels, and none
  of the first design's."""
  missing = [k for k in SEGMENT_KERNELS[key]
             if not any(k in n for n in names)]
  tiles = sorted(n for n in names
                 if any(k in n for k in TILE_TRIGRAM_KERNELS))
  check(not missing and not tiles,
        f'the bfloat16 trigram {key} at {where} launched {sorted(names)}: '
        f'missing {missing}, first-design kernels {tiles}')


def phase_trigram_probe(torch, lattices, contexts, alignments, weight_fns,
                        trigram_scan, records):
  """Phase 10b: the trigram kernels alone at the JAX package's trigram probe
  shapes (benchmarks/tpu_trigram_probe.py: V=64, S=4161, B=8, every row
  T=200, h=emb=feature=512, FLD(2), bf16), against their plain versions.
  Adds the times to phase 10's records."""
  vocab, batch_size, max_t = 64, 8, 200
  lattice, params = bench_lattice(torch, lattices, contexts, alignments,
                                  weight_fns, vocab, context_size=2)
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(rand(rng, (batch_size, max_t, 512), 0.5)).cuda()
  _, pf, pc, head = staged_lattice_inputs(torch, lattice, params, frames)
  is_pad = padding(torch, torch.full((batch_size,), max_t), max_t)
  g = torch.ones((batch_size,), device='cuda')
  kw = dict(max_expansions=2, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  probe = kernels_alone(torch, trigram_kernels(trigram_scan), pf, pc, head,
                        is_pad, g, kw, (None, None), float64_reference=True)
  say('trigram-probe', probe['line'])
  for key in ('forward', 'backward'):
    records[key].update(probe_ms=probe[key]['ms'],
                        probe_plain_ms=probe[key]['plain_ms'],
                        probe_bound_ms=probe[key]['bound_ms'])
  # By kernel: one forward and one backward under the profiler, through
  # the segment kernels.
  parts = []
  for key, call in trigram_calls(trigram_scan, pf, pc, head, is_pad, g,
                                 kw).items():
    call()  # warm-up
    _, spans = device_spans(torch, call)
    check_segment_route({name for _, _, name in spans}, key,
                        'the probe shapes')
    names = {}
    for start, stop, name in spans:
      name = name.replace('(anonymous namespace)::', '').removeprefix('void ')
      name = name.split('(')[0].split('<')[0].strip()
      ms, count = names.get(name, (0.0, 0))
      names[name] = (ms + (stop - start) / 1e3, count + 1)
    parts.append(f'{key}: ' + ', '.join(
        f'{name} {ms:.3f} ms ({count / max_t:.3g} a frame)'
        for name, (ms, count) in sorted(names.items(),
                                        key=lambda item: -item[1][0])))
  # The tanh term binds the trigram, and no bigram row: a V=1024 frame-row
  # (S=1025, h=512) against its product.
  bigram_tanh = tanh_ms(1025 * 512) * 1e3
  bigram_product = 2 * 1025 * 1024 * 512 / PEAK_OPS['bfloat16'] * 1e6
  say('trigram-probe', 'by kernel (device ms a call, launches a frame) '
      + '; '.join(parts) + f'; peak device memory of the pair '
      f'{probe["peak"] / 2**20:.0f} MiB (forward '
      f'{probe["forward_peak"] / 2**20:.0f}, backward '
      f'{probe["backward_peak"] / 2**20:.0f}); a bigram V=1024 frame-row: '
      f'tanhf {bigram_tanh:.3g} us against the product {bigram_product:.3g} '
      'us')


# Joint+head kernels against their plain versions: the values (blank,
# lexical) relative to max(|value|, 1), the gradients (d_pc, d_pf,
# d_vocab_w, d_blank_w) as |a - b|max / |b|max. Both round the same float32
# joint (the same tanh on the card) and cotangents; the float32 sums differ
# in order only. The bias gradients are the cotangents' sums, one torch sum
# shared by both.
JH_VALUE_NAMES = ('blank*', 'lexical*')
JH_GRAD_NAMES = ('d_pc', 'd_pf', 'd_vocab_w', 'd_blank_w')
JH_RTOL = {'float32': (F32_RTOL, 1e-4), 'bfloat16': (BF16_RTOL, 1e-3)}


def joint_head_inputs(torch, rng, batch, states, vocab, hidden=512):
  """Random joint+head kernel inputs and cotangents of both outputs."""
  t = lambda shape, scale=1.0: torch.from_numpy(rand(rng, shape,
                                                     scale)).cuda()
  inputs = {'pc': t((states, hidden), 0.5), 'pf': t((batch, hidden), 0.5),
            'vocab_w': t((hidden, vocab), hidden**-0.5),
            'blank_w': t((hidden,), hidden**-0.5),
            'vocab_b': t((vocab,), 0.1),
            'blank_b': torch.tensor(0.3, device='cuda')}
  return inputs, t((batch, states)), t((batch, states, vocab))


def joint_head_pair(torch, joint_head, inputs, g_blank, g_lexical, dtype,
                    plain=False):
  """(forward outputs, backward outputs) of the kernels or their plain
  versions."""
  forward, backward = ((joint_head.joint_head_forward_plain,
                        joint_head.joint_head_backward_plain) if plain else
                       (joint_head.joint_head_forward,
                        joint_head.joint_head_backward))
  head = [inputs[n] for n in ('pc', 'pf', 'vocab_w', 'blank_w')]
  return (forward(**inputs, compute_dtype=dtype),
          backward(*head, g_blank, g_lexical, compute_dtype=dtype))


def phase_joint_head_vs_plain(torch, joint_head):
  """Phase 3c: the joint+head kernels against their plain versions, B in
  {1, 8}, S in {1025, 4161, 1100}, V in {1024, 64, 1000}, h=512, float32
  and bfloat16; and S=1100, V=1001, where the bfloat16 forward stores
  through shared memory and the backward stages without 16-byte loads (V
  not a multiple of 4)."""
  rng = np.random.default_rng(11)
  lines = []
  for states, vocab in [(s, v) for s in (1025, 4161, 1100)
                        for v in (1024, 64, 1000)] + [(1100, 1001)]:
    worst = {}
    for batch in (1, 8):
      inputs, g_blank, g_lexical = joint_head_inputs(torch, rng, batch,
                                                     states, vocab)
      for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype)[6:]
        fwd_k, bwd_k = joint_head_pair(torch, joint_head, inputs, g_blank,
                                       g_lexical, dtype)
        fwd_p, bwd_p = joint_head_pair(torch, joint_head, inputs, g_blank,
                                       g_lexical, dtype, plain=True)
        torch.cuda.synchronize()
        try:
          errors = max_errors(torch, fwd_k, fwd_p, JH_VALUE_NAMES,
                              JH_RTOL[name])
          errors.update(max_errors(torch, bwd_k, bwd_p, JH_GRAD_NAMES,
                                   JH_RTOL[name]))
        except SmokeFailure as e:
          raise SmokeFailure(f'joint_head B={batch} S={states} V={vocab} '
                             f'{name}: {e}') from None
        for n, (e, _) in errors.items():
          key = (name, 'values' if n in ('blank', 'lexical') else
                 'gradients')
          worst[key] = max(worst.get(key, (0.0, '')), (e, n))
    lines.append(f'S={states} V={vocab} h=512 B in (1, 8): ' + '; '.join(
        f'{dt} {kind} max rel {e:.2e} ({n})'
        for (dt, kind), (e, n) in sorted(worst.items())))
  return lines


# Phase 11: the densified headline (bench.py::build_lattice(vocab=1024)
# with its context a NextStateTable) at phase 6's utterances.
NEXT_STATE_VOCAB, NEXT_STATE_HIDDEN = 1024, 512


def next_state_lattices(torch, lattices, contexts, alignments, weight_fns):
  """(densified NextStateTable lattice, FullNGram lattice, FullNGram lattice
  with fused='never'): bench.py::build_lattice(vocab=1024)'s FLD(2),
  SharedEmbCacher(1025, 512), JointWeightFn(1024, 512, bfloat16),
  features 512."""
  vocab, hidden = NEXT_STATE_VOCAB, NEXT_STATE_HIDDEN
  ngram = contexts.FullNGram(vocab_size=vocab, context_size=1)

  def make(context, fused='auto'):
    return lattices.RecognitionLattice(
        context=context,
        alignment=alignments.FrameLabelDependent(max_expansions=2),
        weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
            num_context_states=ctx.shape()[0], embedding_size=hidden),
        weight_fn_factory=lambda ctx: weight_fns.JointWeightFn(
            vocab_size=vocab, hidden_size=hidden,
            compute_dtype=torch.bfloat16),
        fused=fused)

  return (make(contexts.NextStateTable(ngram.next_state_table())),
          make(ngram), make(ngram, 'never'))


# The leaves whose gradients the generic route rounds to bfloat16: apply's
# projections round their inputs to the compute type (as the JAX package's
# XLA route does), and autograd rounds the inputs' cotangents with them.
# The kernels' route keeps them in float32; a comparison allows one
# bfloat16 step of each entry (at most 2**-7 of it) on top of the rule.
ROUNDED_GRADIENTS = ("['cacher']['embedding']",
                     "['weight_fn']['context_proj']",
                     "['weight_fn']['frame_proj']")


def compare_steps(torch, pytree, params, got, want, what):
  """Holds (loss, gradients) to (loss, gradients) by phase 6's rules (loss
  rtol 1e-4, each gradient within 1e-3 of the step's largest), with the
  bfloat16 step of ROUNDED_GRADIENTS; returns a report."""
  (loss_a, grads_a), (loss_b, grads_b) = got, want
  loss_rel = abs(loss_a - loss_b) / abs(loss_b)
  check(np.isfinite(loss_a) and loss_rel <= STEP_LOSS_RTOL,
        f'step-1 loss {loss_a} vs {loss_b} ({what})')
  paths = [pytree.keystr(path) for path, _ in
           pytree.tree_flatten_with_path(params)[0]]
  largest = max(g.abs().max().item() for g in grads_b)
  worst = (0.0, '')
  for path, a, b in zip(paths, grads_a, grads_b):
    check(bool(torch.isfinite(a).all()), f'{path}: gradient not finite')
    excess = (a - b).abs()
    if path in ROUNDED_GRADIENTS:
      excess = excess - 2.0**-7 * b.abs()
    err = excess.max().item() / largest
    worst = max(worst, (err, path))
  check(worst[0] <= STEP_GRAD_RTOL,
        f'step-1 gradient of {worst[1]}: {worst[0]:.3g} of the largest '
        f'gradient ({what})')
  return (f'loss {loss_a:.7g} vs {loss_b:.7g} (rel {loss_rel:.2e}); '
          f'gradients within {worst[0]:.2e} of the largest {largest:.3g} '
          f'({worst[1]})')


def phase_next_state(torch, lattices, contexts, alignments, weight_fns, gnat,
                     fused_scan, joint_head, semirings, pytree, modules):
  """Phase 11: the NextStateTable main path, the densified headline lattice
  at phase 6's 8 utterances and label counts. Step 1 (the loss, mean over
  the batch, and its gradients) through the joint+head plain versions, the
  FullNGram lattice's bigram kernels and its generic route
  (fused='never'), then 3 counted and timed train steps (AdamW,
  ``make_optimizer``) through the joint+head kernels, whose first gradients
  are held to those three (the same function: the frames and the
  projections' inputs lie on the bfloat16 grid, where the generic route's
  rounding of them is exact), the last one profiled; the generic decode
  against the Viterbi kernel's; label_marginals against the bigram
  marginals kernel's. Prints its lines; returns the joint+head launches by
  path."""
  dense, ngram, never = next_state_lattices(torch, lattices, contexts,
                                            alignments, weight_fns)
  params = dense.init(torch.Generator().manual_seed(0),
                      feature_size=NEXT_STATE_HIDDEN, device='cuda')
  grid = lambda x: x.to(torch.bfloat16).float()
  rounded = lambda p: (p['cacher']['embedding'],
                       p['weight_fn']['context_proj'],
                       p['weight_fn']['frame_proj'])
  with torch.no_grad():
    for leaf in rounded(params):
      leaf.copy_(grid(leaf))
  leaves = pytree.tree_leaves(params)
  for leaf in leaves:
    leaf.requires_grad_(True)
  rng = np.random.default_rng(0)
  batch_size, max_t = len(NUM_FRAMES), max(NUM_FRAMES)
  frames = grid(torch.from_numpy(
      rand(rng, (batch_size, max_t, NEXT_STATE_HIDDEN), 0.5)).cuda())
  labels = torch.from_numpy(rng.integers(
      1, NEXT_STATE_VOCAB + 1, size=(batch_size, max(NUM_LABELS)))).cuda()
  num_frames = torch.tensor(NUM_FRAMES, device='cuda')
  num_labels = torch.tensor(NUM_LABELS, device='cuda')
  batch = (frames, num_frames, labels, num_labels)
  real_frames = sum(NUM_FRAMES)
  mean_loss = lambda lattice, b=batch: lambda: lattice.loss(params,
                                                            *b).mean()
  plain = (joint_head.joint_head_forward_plain,
           joint_head.joint_head_backward_plain)
  per_step = {'forward_launches': 2 * max_t, 'backward_launches': max_t}
  idle = lambda: {m.__name__: v for m in modules
                  for v in [sum(counts(m).values())] if v}

  # Warm-up: 16 frames through each route timed below, so that no timed
  # step pays the first calls' costs.
  short = (frames[:, :16].contiguous(), num_frames.clamp(max=16),
           labels[:, :1], num_labels.clamp(max=1))
  for lattice in (dense, ngram, never):
    loss_and_grads(torch, leaves, mean_loss(lattice, short))
  with joint_head.using(*plain):
    loss_and_grads(torch, leaves, mean_loss(dense, short))

  # Step 1 through the joint+head plain versions, the bigram kernels and
  # the FullNGram lattice's generic route.
  reset_counts(joint_head, *modules)
  with joint_head.using(*plain):
    step_p, plain_ms = timed(torch, lambda: loss_and_grads(
        torch, leaves, mean_loss(dense)))
  check(dense.last_path == 'generic',
        f'the NextStateTable loss took {dense.last_path!r}, not generic')
  check(not idle() and not any(counts(joint_head).values()),
        f'the plain versions\' step launched kernels: {idle()}, joint+head '
        f'{counts(joint_head)}')
  step_n, ngram_ms = timed(torch, lambda: loss_and_grads(
      torch, leaves, mean_loss(ngram)))
  check(ngram.last_path == 'kernel',
        f'the FullNGram loss took {ngram.last_path!r}, not kernel')
  reset_counts(joint_head, *modules)
  step_v, never_ms = timed(torch, lambda: loss_and_grads(
      torch, leaves, mean_loss(never)))
  check(never.last_path == 'generic' and counts(joint_head) == per_step and
        not idle(), f"fused='never' took {never.last_path!r} with joint+head "
        f'launches {counts(joint_head)} and lattice kernels {idle()}')

  # The main path: train steps through the joint+head kernels, counted and
  # timed; step 1's gradients are kept before the optimizer clips them.
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  opt_state = optimizer.init(params)
  first_grads = []

  def train_step():
    opt_state.adamw.zero_grad(set_to_none=True)
    loss = mean_loss(dense)()
    loss.backward()
    if not first_grads:
      first_grads.extend(leaf.grad.clone() for leaf in leaves)
    optimizer.apply_gradients(opt_state)
    return loss.detach()

  # The last step runs under the profiler, its time taken inside it.
  losses, step_ms, launches = [], [], []
  reset_counts(joint_head, *modules)
  for i in range(TRAIN_STEPS):
    before = counts(joint_head)
    if i < TRAIN_STEPS - 1:
      loss, ms = timed(torch, train_step)
    else:
      t0 = time.perf_counter()
      (loss, ms), report = device_profile(
          torch, lambda: timed(torch, train_step))
      profiled_s = time.perf_counter() - t0
    losses.append(loss.item())
    step_ms.append(ms)
    launches.append({n: v - before[n] for n, v in counts(joint_head).items()})
  check(all(x == per_step for x in launches),
        f'train steps launched the joint+head kernels {launches}, not '
        f'{per_step} each')
  check(not idle(), f'the train steps launched lattice kernels: {idle()}')
  check(dense.last_path == 'generic', 'the train steps left the generic '
        'route')
  check(all(np.isfinite(losses)) and
        all(b < a for a, b in zip(losses, losses[1:])),
        f'losses not finite and decreasing: {losses}')
  step_k = (losses[0], first_grads)
  vs_plain = compare_steps(torch, pytree, params, step_k, step_p,
                           'joint+head kernels vs plain versions')
  vs_ngram = compare_steps(torch, pytree, params, step_k, step_n,
                           'NextStateTable generic route vs FullNGram '
                           'bigram kernels')
  vs_never = compare_steps(torch, pytree, params, step_k, step_v,
                           "NextStateTable vs FullNGram fused='never'")
  train_launches = counts(joint_head)
  say('next-state', f'densified headline (NextStateTable(FullNGram(1024, '
      f'1)), S=1025, V=1024, FLD(2), h=emb=feature=512, bf16) B='
      f'{batch_size} T_max={max_t} U_max={max(NUM_LABELS)}, step 1 (loss '
      f'mean + backward) through the joint+head kernels vs their plain '
      f'versions: {vs_plain}; vs the FullNGram lattice through the bigram '
      f'kernels: {vs_ngram}; vs its generic route: {vs_never}')
  say('next-state', f'{TRAIN_STEPS} train steps (joint+head kernels): '
      'losses ' + ', '.join(f'{x:.7g}' for x in losses) + '; step ms '
      + ', '.join(f'{x:.1f}' for x in step_ms) + ' (the last profiled; '
      + ', '.join(f'{real_frames / x * 1e3:.0f}' for x in step_ms)
      + f' real frames/s); joint+head launches {train_launches}, '
      f'{per_step} per step; no lattice kernel launched. Loss forward+'
      f'backward, step 1: joint+head plain versions {plain_ms:.1f} ms; '
      f'FullNGram bigram kernels {ngram_ms:.1f} ms; FullNGram '
      f"fused='never' (generic, joint+head kernels) {never_ms:.1f} ms")
  say('next-state', f'step {TRAIN_STEPS} under the profiler: {report} '
      f'(profiled in {profiled_s:.1f} s)')

  # Decode (the generic route) against the Viterbi kernel's. The trained
  # projections' inputs are put back on the bfloat16 grid, where the
  # generic route's rounding of them is exact, so that both routes
  # compute one function.
  detached = pytree.tree_map(lambda x: x.detach().clone(), params)
  for leaf in rounded(detached):
    leaf.copy_(grid(leaf))
  reset_counts(joint_head, *modules)
  with torch.no_grad():
    decoded, decode_ms = timed(torch, lambda: dense.shortest_path(
        detached, frames, num_frames))
  decode_launches = counts(joint_head)
  check(dense.last_path == 'generic' and decode_launches == {
      'forward_launches': 2 * max_t, 'backward_launches': 0} and not idle(),
        f'the NextStateTable decode took {dense.last_path!r} with joint+head '
        f'launches {decode_launches} and lattice kernels {idle()}')
  with torch.no_grad():
    viterbi_out, viterbi_ms = timed(torch, lambda: ngram.shortest_path(
        detached, frames, num_frames))
    check(ngram.last_path == 'kernel', 'the FullNGram decode left the '
          'Viterbi kernel')
    cache, pf, pc, head = staged_lattice_inputs(torch, ngram, detached,
                                                frames)
    rescored = rescore(torch, decoded[0], num_frames, pf, pc, head,
                       max_expansions=2, frame_dependent=False,
                       compute_dtype=torch.bfloat16)
  decode_report = compare_decodes(torch, decoded, viterbi_out, rescored,
                                  torch.bfloat16)
  say('next-state', f'decode: NextStateTable generic route {decode_ms:.1f} '
      f'ms ({real_frames / decode_ms * 1e3:.0f} real frames/s, joint+head '
      f'forward launches {decode_launches["forward_launches"]}), FullNGram '
      f'Viterbi kernel {viterbi_ms:.1f} ms; generic vs kernel: '
      f'{decode_report}')

  # Posteriors (the generic route) against the bigram marginals kernel's.
  reset_counts(joint_head, *modules)
  with torch.no_grad():
    (bm, lp), marg_ms = timed(torch, lambda: dense.label_marginals(
        detached, frames, num_frames))
  marg_launches = counts(joint_head)
  check(dense.last_path == 'generic' and marg_launches == {
      'forward_launches': 2 * max_t, 'backward_launches': 0} and not idle(),
        f'the NextStateTable label_marginals took {dense.last_path!r} with '
        f'joint+head launches {marg_launches} and lattice kernels {idle()}')
  with torch.no_grad():
    (bm_k, lp_k), kernel_marg_ms = timed(torch, lambda: ngram.label_marginals(
        detached, frames, num_frames))
    check(ngram.last_path == 'kernel', 'the FullNGram label_marginals left '
          'the kernels')
    is_pad = padding(torch, num_frames, max_t)
    log_z = fused_scan.fused_forward(
        pf, pc, head, is_pad, with_residuals=False, max_expansions=2,
        frame_dependent=False, compute_dtype=torch.bfloat16)[0]
  tol = long_rtol(log_z)
  errors = max_errors(torch, (bm, lp), (bm_k, lp_k), MARGINALS_NAMES,
                      (BF16_RTOL, tol))
  kernel_drift = blank_drift(torch, bm_k, num_frames)
  drift, ratio = posterior_checks(torch, bm, lp, num_frames, 2,
                                  2 * kernel_drift + tol, tol)
  say('next-state', f'label_marginals: NextStateTable generic route '
      f'{marg_ms:.1f} ms (joint+head forward launches '
      f'{marg_launches["forward_launches"]}), FullNGram marginals kernels '
      f'{kernel_marg_ms:.1f} ms; generic vs kernels (|log Z| up to '
      f'{log_z.abs().max().item():.4g}, rtol {tol:.2e}): bm '
      f'{errors["bm"][0]:.2e}, lp {errors["lp"][0]:.2e}; blank sums within '
      f'exp(+-{drift:.3g}) of 1 (kernels {kernel_drift:.3g}), label sums at '
      f'most {ratio:.4f} blank sums; padding 0')
  return {'NextStateTable train steps': train_launches,
          'NextStateTable decode': decode_launches,
          'NextStateTable label_marginals': marg_launches}


def joint_head_library(torch, inputs, g_blank, g_lexical, dtype):
  """The library compositions of the same functions: tanh of the broadcast
  sum, then one addmm over the combined head (forward); the two mm of the
  backward with the tanh derivative between them. In ``dtype``."""
  pc, pf = inputs['pc'], inputs['pf']
  batch, states = g_blank.shape
  w = torch.cat([inputs['vocab_w'], inputs['blank_w'][:, None]], 1).to(dtype)
  b = torch.cat([inputs['vocab_b'], inputs['blank_b'][None]]).to(dtype)
  g = torch.cat([g_lexical, g_blank[..., None]], -1).view(batch * states, -1)

  def forward():
    joint = torch.tanh(pc[None] + pf[:, None]).to(dtype)
    return torch.addmm(b, joint.view(batch * states, -1), w)

  def backward():
    joint = torch.tanh(pc[None] + pf[:, None]).view(batch * states, -1)
    gc = g.to(dtype)
    du = (gc @ w.t()).float() * (1 - joint * joint)
    du = du.view(batch, states, -1)
    return (du.sum(0), du.sum(1), joint.to(dtype).t() @ gc)

  return forward, backward


def phase_joint_head_alone(torch, joint_head, launches):
  """Phase 11b: the joint+head kernels alone, timed against their plain
  versions and the library compositions, at the densified headline's
  per-frame shape (B=8, S=1025, V=1024, bf16), the trigram probe's (B=8,
  S=4161, V=64, float32, as phase 10's generic decode runs it; the
  labels-major float32 tiles) and the MWER step's beta pass (B=8, S=1025,
  V=1024, float32; the rows-major float32 tiles): per call over 100 calls
  back to back (CUDA events; a call this short can be bound by its host
  work) and, for the kernels, their device time per call (the profiler).
  Returns the kernels' JSON records (the headline shape's numbers, the
  probe's and the MWER shape's beside them)."""
  rng = np.random.default_rng(12)
  records = {}
  for tag, (states, vocab, dtype) in (
      ('headline', (1025, 1024, torch.bfloat16)),
      ('probe', (4161, 64, torch.float32)),
      ('mwer', (1025, 1024, torch.float32))):
    batch, hidden = 8, 512
    inputs, g_blank, g_lexical = joint_head_inputs(torch, rng, batch, states,
                                                   vocab, hidden)
    head = [inputs[n] for n in ('pc', 'pf', 'vocab_w', 'blank_w')]
    fwd = lambda: joint_head.joint_head_forward(**inputs,
                                                compute_dtype=dtype)
    bwd = lambda: joint_head.joint_head_backward(*head, g_blank, g_lexical,
                                                 compute_dtype=dtype)
    fwd_plain = lambda: joint_head.joint_head_forward_plain(
        **inputs, compute_dtype=dtype)
    bwd_plain = lambda: joint_head.joint_head_backward_plain(
        *head, g_blank, g_lexical, compute_dtype=dtype)
    lib_fwd, lib_bwd = joint_head_library(torch, inputs, g_blank, g_lexical,
                                          dtype)
    times = {}
    for name, fn in (('fwd', fwd), ('bwd', bwd), ('fwd_plain', fwd_plain),
                     ('bwd_plain', bwd_plain), ('lib_fwd', lib_fwd),
                     ('lib_bwd', lib_bwd)):
      fn()  # warm-up
      times[name] = timed(torch, fn, repeats=100)[1]
    device = {'fwd': device_ms(torch, fwd, 100),
              'bwd': device_ms(torch, bwd, 100)}
    name = str(dtype)[6:]
    errors = max_errors(torch, fwd(), fwd_plain(), JH_VALUE_NAMES,
                        JH_RTOL[name])
    errors.update(max_errors(torch, bwd(), bwd_plain(), JH_GRAD_NAMES,
                             JH_RTOL[name]))
    flops = 2.0 * batch * states * hidden * (vocab + 1)
    fwd_bytes = nbytes(*inputs.values()) + nbytes(*fwd())
    bwd_bytes = (nbytes(*head, g_blank, g_lexical) + nbytes(*bwd()))
    say('joint-head-alone', f'{tag} shape B={batch} S={states} V={vocab} '
        f'h={hidden} {name}: forward kernel {times["fwd"]:.4f} ms (device '
        f'{device["fwd"]:.4f}), plain {times["fwd_plain"]:.3f} ms, library '
        f'(tanh + addmm) {times["lib_fwd"]:.3f} ms, bound '
        f'{bound(flops, fwd_bytes, name)[0]:.4f} ms; backward kernel '
        f'{times["bwd"]:.4f} ms (device {device["bwd"]:.4f}), plain '
        f'{times["bwd_plain"]:.3f} ms, library (mm, tanh derivative, mm) '
        f'{times["lib_bwd"]:.3f} ms, bound '
        f'{bound(2 * flops, bwd_bytes, name)[0]:.4f} ms; vs plain: '
        + ', '.join(f'{n} {e:.2e}' for n, (e, _) in errors.items()))
    value_err = max(errors[n][1] for n in ('blank', 'lexical'))
    grad_err = max(errors[n][1] for n in ('d_pc', 'd_pf', 'd_vocab_w',
                                          'd_blank_w'))
    for key, (ms, dev_ms, plain_ms, lib_ms, ops, traffic, err) in {
        'forward': (times['fwd'], device['fwd'], times['fwd_plain'],
                    times['lib_fwd'], flops, fwd_bytes, value_err),
        'backward': (times['bwd'], device['bwd'], times['bwd_plain'],
                     times['lib_bwd'], 2 * flops, bwd_bytes,
                     grad_err)}.items():
      if tag == 'headline':
        record = kernel_record(
            f'joint_head_{key}',
            'head_product.cuh' if key == 'forward' else 'joint_head.cu',
            'joint_head.py:187' if key == 'forward' else 'joint_head.py:248',
            sum(v[f'{key}_launches'] for v in launches.values()), err, ms,
            plain_ms, ops, traffic, name,
            launches_by_path={p: v[f'{key}_launches']
                              for p, v in launches.items()},
            device_ms=dev_ms)
        record['library_ms'] = lib_ms
        records[key] = record
      else:
        records[key].update({
            f'{tag}_ms': ms, f'{tag}_device_ms': dev_ms,
            f'{tag}_plain_ms': plain_ms, f'{tag}_library_ms': lib_ms,
            f'{tag}_bound_ms': bound(ops, traffic, name)[0],
            f'{tag}_max_abs_err': err})
  return records


def tp_batch(torch, config):
  """Phase 6's utterances (features and labels from numpy seed 0), on the
  card."""
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(rand(
      rng, (len(NUM_FRAMES), max(NUM_FRAMES), config.feature_size))).cuda()
  labels = torch.from_numpy(rng.integers(
      1, config.vocab_size + 1, size=(len(NUM_FRAMES), max(NUM_LABELS)))).cuda()
  return (frames, torch.tensor(NUM_FRAMES, device='cuda'), labels,
          torch.tensor(NUM_LABELS, device='cuda'))


def float64_frame_reduce(torch, sharded_scan):
  """A frame reduction through the plain version in float64 (the same
  bfloat16 roundings of the joint and head, float64 sums), checkpointed
  per call so that the backward recomputes each frame's [B, S, V] block:
  the float64 reference of the tensor-parallel loss (``reduce=``)."""
  import torch.utils.checkpoint
  forward = functools.partial(sharded_scan.frame_reduce_plain,
                              compute_dtype=torch.bfloat16)
  return lambda *args: torch.utils.checkpoint.checkpoint(
      forward, *args, use_reentrant=False)


def lattice_step1(torch, pytree, lattice_params, encoded, dtype, loss_fn):
  """(mean loss, {leaf path or 'encoded': float64 gradient}) of the lattice
  loss ``loss_fn(params, encoded)`` in ``dtype`` on fixed encoder outputs."""
  params = pytree.tree_map(
      lambda x: x.detach().to(dtype).requires_grad_(True), lattice_params)
  encoded = encoded.detach().to(dtype).requires_grad_(True)
  per_seq = loss_fn(params, encoded)
  finite = torch.isfinite(per_seq)
  loss = torch.where(finite, per_seq, 0.0).sum() / finite.sum().clamp(min=1)
  loss.backward()
  torch.cuda.synchronize()
  grads = {pytree.keystr(path): leaf.grad.double() for path, leaf in
           pytree.tree_flatten_with_path(params)[0]}
  grads['encoded'] = encoded.grad.double()
  return loss.item(), grads


def phase_tensor_parallel(torch, gnat, presets, fused_scan, sharded_scan,
                          sharding, pytree):
  """Phase 12: the tensor-parallel training main path on a one-process
  NCCL group (one card: NCCL takes no two ranks on one GPU), a model axis
  of 1. gnat_global_bigram() at full width on phase 6's utterances.

  Step 1, the lattice loss on the encoder's outputs through three routes:
  the single-device bigram kernels, ``tp_lattice_loss`` through the
  frame_reduce kernels, and ``tp_lattice_loss`` in float64 (the plain
  versions, the same function). The losses agree to rtol 1e-4; each
  gradient (lattice parameters and the encoder outputs') of the
  tensor-parallel route is within max(1e-3, twice the single-device
  route's error) of the float64 one, both relative to the largest float64
  gradient: at T=1600 float32's log-space rounding moves the single-device
  route's blank-head gradients by more than 1e-3 (phases 10/10b judge the
  trigram kernels so). Then 3 counted and timed ``make_tp_train_step``
  steps through the frame_reduce kernels (2 launches per frame each way
  under FLD(2), no bigram kernel), losses falling, the first one's loss
  the tensor-parallel route's; one more step profiled. Returns the
  frame_reduce (forward, backward) launches of the 3 steps."""
  import torch.distributed as dist
  dist.init_process_group('nccl', store=dist.HashStore(), rank=0,
                          world_size=1)
  try:
    mesh = sharding.make_mesh(model_parallel=1)
    config = presets.gnat_global_bigram()
    model = gnat.GNATModel(config, device='cuda')
    optimizer = gnat.make_optimizer(LEARNING_RATE)
    full = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                 optimizer)
    batch = tp_batch(torch, config)
    max_t = batch[0].shape[1]
    step, shard_state = sharding.make_tp_train_step(model, optimizer, mesh)
    state = shard_state(full)
    local = sharding.shard_batch(batch, mesh)

    # Step 1 of the lattice loss through the three routes.
    t0 = time.perf_counter()
    with torch.no_grad():
      encoded = model.encoder.apply(full.params['encoder'], *batch[:2])
    lattice, rest = model.lattice, batch[1:]
    group = mesh.get_group('model')
    routes = {
        'single-device': (torch.float32,
                          lambda p, e: lattice.loss(p, e, *rest)),
        'tensor-parallel': (torch.float32,
                            lambda p, e: sharded_scan.tp_lattice_loss(
                                lattice, p, e, *rest, group=group)),
        'float64': (torch.float64,
                    lambda p, e: sharded_scan.tp_lattice_loss(
                        lattice, p, e, *rest,
                        reduce=float64_frame_reduce(torch, sharded_scan))),
    }
    reset_counts(sharded_scan)
    results = {}
    for name, (dtype, loss_fn) in routes.items():
      results[name] = lattice_step1(torch, pytree, full.params['lattice'],
                                    encoded, dtype, loss_fn)
      if name == 'single-device':
        check(lattice.last_path == 'kernel',
              f'last_path is {lattice.last_path!r}, not kernel')
    check((sharded_scan.forward_launches, sharded_scan.backward_launches) ==
          (2 * max_t, 2 * max_t),
          f'step 1 launched frame_reduce {counts(sharded_scan)}, not '
          f'{2 * max_t} each way')
    (loss_sd, sd), (loss_tp, tp), (loss_64, ref) = results.values()
    for what, loss in (('single-device', loss_sd), ('float64', loss_64)):
      rel = abs(loss_tp - loss) / abs(loss)
      check(np.isfinite(loss_tp) and rel <= STEP_LOSS_RTOL,
            f'step-1 loss {loss_tp} tensor-parallel vs {loss} {what}')
    largest = max(g.abs().max().item() for g in ref.values())
    errors = {name: tuple((g[name] - r).abs().max().item() / largest
                          for g in (tp, sd))
              for name, r in ref.items()}
    for name, (err_tp, err_sd) in errors.items():
      check(bool(torch.isfinite(tp[name]).all()), f'{name}: not finite')
      check(err_tp <= max(STEP_GRAD_RTOL, 2 * err_sd),
            f'step-1 gradient of {name}: tensor-parallel {err_tp:.3g} of '
            f'the largest from float64, single-device {err_sd:.3g}')
    worst = {route: max((e[i], name) for name, e in errors.items())
             for i, route in enumerate(('tensor-parallel', 'single-device'))}
    vs_sd = max(((tp[n] - sd[n]).abs().max().item() / largest, n)
                for n in ref)
    # FLD's blank_b gradient is a structural zero: its float32 residue.
    blank_b = "['weight_fn']['blank_b']"
    say('tensor-parallel', f'step 1 (lattice loss on the encoder outputs): '
        f'loss tensor-parallel {loss_tp:.9g}, single-device {loss_sd:.9g}, '
        f'float64 {loss_64:.9g}; gradients (lattice leaves and encoder '
        f'outputs) vs float64, of the largest {largest:.4g}: '
        f'tensor-parallel at most {worst["tensor-parallel"][0]:.2e} '
        f'({worst["tensor-parallel"][1]}), single-device bigram kernels at '
        f'most {worst["single-device"][0]:.2e} '
        f'({worst["single-device"][1]}); tensor-parallel vs single-device '
        f'{vs_sd[0]:.2e} ({vs_sd[1]}); per leaf (tensor-parallel, '
        f'single-device) vs float64: ' + ', '.join(
            f'{name} ({a:.2e}, {b:.2e})' for name, (a, b) in errors.items())
        + f'; blank_b gradient tensor-parallel {tp[blank_b].item():.6g}, '
        f'single-device {sd[blank_b].item():.6g}, float64 '
        f'{ref[blank_b].item():.3g} ({time.perf_counter() - t0:.1f} s)')

    # The main path: 3 train steps, counted and timed.
    losses, step_ms, per_step = [], [], []
    reset_counts(sharded_scan, fused_scan)
    for _ in range(TRAIN_STEPS):
      before = (sharded_scan.forward_launches, sharded_scan.backward_launches)
      start = torch.cuda.Event(enable_timing=True)
      end = torch.cuda.Event(enable_timing=True)
      start.record()
      state, loss = step(state, *local)
      end.record()
      torch.cuda.synchronize()
      step_ms.append(start.elapsed_time(end))
      losses.append(loss.item())
      per_step.append((sharded_scan.forward_launches - before[0],
                       sharded_scan.backward_launches - before[1]))
    launches = (sharded_scan.forward_launches, sharded_scan.backward_launches)
    check(all(n == (2 * max_t, 2 * max_t) for n in per_step),
          f'frame_reduce launches per step {per_step}, not {2 * max_t} each '
          'way')
    check(not any(counts(fused_scan).values()),
          f'the tensor-parallel steps launched bigram kernels: '
          f'{counts(fused_scan)}')
    check(all(np.isfinite(losses)) and
          all(b < a for a, b in zip(losses, losses[1:])),
          f'losses not finite and decreasing: {losses}')
    check(abs(losses[0] - loss_tp) <= 1e-6 * abs(loss_tp),
          f'train step 1 loss {losses[0]} != the tensor-parallel route\'s '
          f'{loss_tp}')
    real_frames = sum(NUM_FRAMES)
    say('tensor-parallel',
        f'gnat_global_bigram B={len(NUM_FRAMES)} T_max={max_t} '
        f'U_max={max(NUM_LABELS)}, {TRAIN_STEPS} make_tp_train_step steps: '
        'losses ' + ', '.join(f'{x:.6g}' for x in losses) + '; step ms ' +
        ', '.join(f'{x:.1f}' for x in step_ms) + ' (' +
        ', '.join(f'{real_frames / x * 1e3:.0f}' for x in step_ms) +
        f' real frames/s); frame_reduce launches per step (forward, '
        f'backward) {per_step}; no bigram kernel launched')
    say('tensor-parallel', 'one more step under the profiler: ' +
        device_profile(torch, lambda: step(state, *local))[1])
    risk_data_parallel(torch, gnat, sharding, pytree, model, mesh,
                       full.params, batch, local)
  finally:
    dist.destroy_process_group()
  return launches


def risk_data_parallel(torch, gnat, sharding, pytree, model, mesh, params,
                       batch, local):
  """The data-parallel expected-risk step (``make_shard_map_risk_train_step``,
  phase 13's estimator, samples and NLL weight) on phase 12's group,
  against the single-device ``risk_train_step(..., per_example_keys=True)``
  from one seed: the same samples, metrics to rtol 1e-5, gradients (before
  the clip, which is set out of reach) within 1e-5 of the largest."""
  t0 = time.perf_counter()
  optimizer = gnat.make_optimizer(LEARNING_RATE, clip_norm=1e9)
  state = gnat.GNATTrainState(params, optimizer.init(params), 0)
  leaves = pytree.tree_leaves(params)
  seed = lambda: torch.Generator(device='cuda').manual_seed(MWER_SEED)
  step = sharding.make_shard_map_risk_train_step(
      model, optimizer, mesh, num_samples=MWER_SAMPLES, estimator='mwer',
      nll_weight=MWER_NLL_WEIGHT)
  dp, sd = {}, {}
  with sampler_tap(torch, model.lattice, dp):
    (dp_metrics, dp_ms) = timed(
        torch, lambda: step.loss_and_grads(state, *local, seed()))
  dp_grads = [leaf.grad.clone() for leaf in leaves]
  with sampler_tap(torch, model.lattice, sd):
    (_, sd_metrics), sd_ms = timed(torch, lambda: gnat.risk_train_step(
        model, optimizer, state, *batch, seed(), num_samples=MWER_SAMPLES,
        estimator='mwer', nll_weight=MWER_NLL_WEIGHT, per_example_keys=True))
  check(torch.equal(dp['labels'], sd['labels']),
        'the data-parallel risk step drew other paths than the '
        'single-device step')
  rel = {k: abs(dp_metrics[k].item() - v.item()) / abs(v.item())
         for k, v in sd_metrics.items()}
  check(set(rel) == {'loss', 'mean_risk', 'nll'} and
        max(rel.values()) <= 1e-5,
        f'data-parallel risk metrics vs single-device: {rel}')
  largest = max(leaf.grad.abs().max().item() for leaf in leaves)
  worst = max((a - leaf.grad).abs().max().item() / largest
              for a, leaf in zip(dp_grads, leaves))
  check(worst <= 1e-5, f'data-parallel risk gradients differ by {worst:.3g} '
        'of the largest')
  say('tensor-parallel', f'data-parallel risk step (world 1) vs '
      f'risk_train_step(per_example_keys=True): same {MWER_SAMPLES} paths a '
      f'row; loss {dp_metrics["loss"].item():.9g} vs '
      f'{sd_metrics["loss"].item():.9g}, metrics within '
      f'{max(rel.values()):.2e}, gradients within {worst:.2e} of the '
      f'largest; {dp_ms:.1f} ms (loss and gradients) and {sd_ms:.1f} ms '
      f'(the step) ({time.perf_counter() - t0:.1f} s)')


FR_VALUE_NAMES = ('red*', 'blank*')
FR_GRAD_NAMES = ('d_vec', 'd_pf', 'd_pc', 'd_vw', 'd_vb', 'd_bw', 'd_bb')
FR_RTOL = {'float32': (F32_RTOL, 1e-4), 'bfloat16': (BF16_RTOL, 1e-3)}


def frame_reduce_inputs(torch, rng, batch, states, vocab, hidden=512):
  """One frame's inputs at an FLD(2) alpha's pattern (a quarter of the
  states dead), and cotangents of both outputs."""
  vec = rand(rng, (batch, states), 3.0)
  vec[:, rng.random(states) < 0.25] = -np.inf
  vec[:, 0] = 0.0
  inputs = {
      'vec': torch.from_numpy(vec).cuda(),
      'pf_t': torch.from_numpy(rand(rng, (batch, hidden), 0.5)).cuda(),
      'pc': torch.from_numpy(rand(rng, (states, hidden), 0.5)).cuda(),
      'vw': torch.from_numpy(rand(rng, (hidden, vocab), hidden**-0.5)).cuda(),
      'vb': torch.from_numpy(rand(rng, (vocab,), 0.1)).cuda(),
      'bw': torch.from_numpy(rand(rng, (hidden,), hidden**-0.5)).cuda(),
      'bb': torch.tensor(0.3, device='cuda'),
  }
  d_red = torch.from_numpy(rand(rng, (batch, vocab))).cuda()
  d_blank = torch.from_numpy(rand(rng, (batch, states))).cuda()
  return inputs, d_red, d_blank


def frame_reduce_library(torch, inputs, d_red, d_blank, dtype):
  """The library composition of the same function: tanh of the broadcast
  sum, one addmm over the combined head, then + vec and logsumexp over S
  (forward); that composition's autograd (backward, timed alone)."""
  vec, pc, pf = inputs['vec'], inputs['pc'], inputs['pf_t']
  batch, states = vec.shape
  leaves = [x.detach().requires_grad_(True) for x in
            (vec, pc, pf, inputs['vw'], inputs['vb'], inputs['bw'],
             inputs['bb'])]

  def forward(vec, pc, pf, vw, vb, bw, bb):
    w = torch.cat([vw, bw[:, None]], 1).to(dtype)
    b = torch.cat([vb, bb[None]]).to(dtype)
    joint = torch.tanh(pc[None] + pf[:, None]).to(dtype)
    out = torch.addmm(b, joint.view(batch * states, -1), w).float()
    out = out.view(batch, states, -1)
    return torch.logsumexp(vec[:, :, None] + out[..., :-1], dim=1), out[..., -1]

  red, blank = forward(*leaves)
  return (lambda: forward(*(x.detach() for x in leaves)),
          lambda: torch.autograd.grad((red, blank), leaves, (d_red, d_blank),
                                      retain_graph=True))


def phase_frame_reduce_alone(torch, sharded_scan, launches):
  """Phase 12b: the frame_reduce kernels alone, timed against their plain
  versions and the library composition at the headline per-frame shape
  (B=8, S=1025, h=512, Vl=1024, bf16) and at one of D=4 shards (Vl=256);
  then the D=4 shards in one process against D=1: red concatenated, the
  blank cotangent given to one shard, the shared gradients summed and the
  head's concatenated, held to the D=1 kernels' and the plain versions'.
  Returns the kernels' JSON records."""
  rng = np.random.default_rng(13)
  dtype, name = torch.bfloat16, 'bfloat16'
  batch, states, hidden, vocab = 8, 1025, 512, 1024
  records, head_inputs = {}, None
  for tag, shard in (('headline', vocab), ('shard', vocab // 4)):
    inputs, d_red, d_blank = frame_reduce_inputs(torch, rng, batch, states,
                                                 shard, hidden)
    if tag == 'headline':
      head_inputs = (inputs, d_red, d_blank)
    args = [inputs[n] for n in ('vec', 'pf_t', 'pc', 'vw', 'vb', 'bw')]
    red_k = sharded_scan.frame_reduce_forward(**inputs, compute_dtype=dtype)[0]
    red_p = sharded_scan.frame_reduce_plain(**inputs, compute_dtype=dtype)[0]
    fns = {
        'fwd': lambda: sharded_scan.frame_reduce_forward(
            **inputs, compute_dtype=dtype),
        'bwd': lambda: sharded_scan.frame_reduce_backward(
            *args, red_k, d_red, d_blank, compute_dtype=dtype),
        'fwd_plain': lambda: sharded_scan.frame_reduce_plain(
            **inputs, compute_dtype=dtype),
        'bwd_plain': lambda: sharded_scan.frame_reduce_backward_plain(
            *args, red_p, d_red, d_blank, compute_dtype=dtype),
    }
    fns['lib_fwd'], fns['lib_bwd'] = frame_reduce_library(
        torch, inputs, d_red, d_blank, dtype)
    times = {}
    for key, fn in fns.items():
      fn()  # warm-up
      times[key] = timed(torch, fn, repeats=10)[1]
    errors = max_errors(torch, fns['fwd'](), fns['fwd_plain'](),
                        FR_VALUE_NAMES, FR_RTOL[name])
    errors.update(max_errors(torch, fns['bwd'](), fns['bwd_plain'](),
                             FR_GRAD_NAMES, FR_RTOL[name]))
    flops = 2.0 * batch * states * hidden * (shard + 1)
    fwd_bytes = nbytes(*inputs.values()) + nbytes(*fns['fwd']())
    bwd_bytes = nbytes(*args, red_k, d_red, d_blank) + nbytes(*fns['bwd']())
    say('frame-reduce-alone', f'{tag} shape B={batch} S={states} h={hidden} '
        f'Vl={shard} {name}: forward kernel {times["fwd"]:.4f} ms, plain '
        f'{times["fwd_plain"]:.4f} ms, library (tanh + addmm + logsumexp) '
        f'{times["lib_fwd"]:.4f} ms, bound '
        f'{bound(flops, fwd_bytes, name)[0]:.4f} ms; backward kernel '
        f'{times["bwd"]:.4f} ms, plain {times["bwd_plain"]:.4f} ms, library '
        f'(its autograd) {times["lib_bwd"]:.4f} ms, bound '
        f'{bound(3 * flops, bwd_bytes, name)[0]:.4f} ms; vs plain: '
        + ', '.join(f'{n} {e:.2e}' for n, (e, _) in errors.items()))
    value_err = max(errors[n][1] for n in ('red', 'blank'))
    grad_err = max(errors[n][1] for n in
                   (n.rstrip('*') for n in FR_GRAD_NAMES))
    for key, (ms, plain_ms, lib_ms, ops, traffic, err) in {
        'forward': (times['fwd'], times['fwd_plain'], times['lib_fwd'],
                    flops, fwd_bytes, value_err),
        'backward': (times['bwd'], times['bwd_plain'], times['lib_bwd'],
                     3 * flops, bwd_bytes, grad_err)}.items():
      if tag == 'headline':
        record = kernel_record(
            f'frame_reduce_{key}',
            'head_product.cuh' if key == 'forward' else 'sharded_scan.cu',
            'sharded_scan.py:68' if key == 'forward' else
            'sharded_scan.py:154',
            launches[0 if key == 'forward' else 1], err, ms, plain_ms, ops,
            traffic, name,
            launches_by_path={'gnat_global_bigram tensor-parallel train '
                              'steps (Megatron encoder)':
                                  launches[0 if key == 'forward' else 1]})
        record['library_ms'] = lib_ms
        records[key] = record
      else:
        records[key].update(
            shard_ms=ms, shard_plain_ms=plain_ms, shard_library_ms=lib_ms,
            shard_bound_ms=bound(ops, traffic, name)[0])

  # D=4 shards in one process against D=1.
  inputs, d_red, d_blank = head_inputs
  args = [inputs[n] for n in ('vec', 'pf_t', 'pc', 'vw', 'vb', 'bw')]
  whole_red, whole_blank = sharded_scan.frame_reduce_forward(
      **inputs, compute_dtype=dtype)
  whole = sharded_scan.frame_reduce_backward(*args, whole_red, d_red, d_blank,
                                             compute_dtype=dtype)
  plain_red, plain_blank = sharded_scan.frame_reduce_plain(
      **inputs, compute_dtype=dtype)
  plain = sharded_scan.frame_reduce_backward_plain(
      *args, plain_red, d_red, d_blank, compute_dtype=dtype)
  reds, grads = [], []
  for r in range(4):
    cols = slice(r * vocab // 4, (r + 1) * vocab // 4)
    shard = dict(inputs, vw=inputs['vw'][:, cols].contiguous(),
                 vb=inputs['vb'][cols].contiguous())
    red, _ = sharded_scan.frame_reduce_forward(**shard, compute_dtype=dtype)
    reds.append(red)
    grads.append(sharded_scan.frame_reduce_backward(
        *(shard[n] for n in ('vec', 'pf_t', 'pc', 'vw', 'vb', 'bw')), red,
        d_red[:, cols].contiguous(),
        d_blank if r == 0 else torch.zeros_like(d_blank),
        compute_dtype=dtype))
  torch.cuda.synchronize()
  shards = [torch.cat(reds, 1), whole_blank]
  shard_grads = [sum(g[i] for g in grads) for i in (0, 1, 2)] + [
      torch.cat([g[3] for g in grads], 1), torch.cat([g[4] for g in grads]),
      sum(g[5] for g in grads), sum(g[6] for g in grads)]
  vs_whole = max_errors(torch, shards, (whole_red, whole_blank),
                        FR_VALUE_NAMES, FR_RTOL[name])
  vs_whole.update(max_errors(torch, shard_grads, whole, FR_GRAD_NAMES,
                             FR_RTOL[name]))
  vs_plain = max_errors(torch, shards, (plain_red, plain_blank),
                        FR_VALUE_NAMES, FR_RTOL[name])
  vs_plain.update(max_errors(torch, shard_grads, plain, FR_GRAD_NAMES,
                             FR_RTOL[name]))
  say('frame-reduce-alone', 'D=4 shards of Vl=256 in one process vs D=1: '
      + ', '.join(f'{n} {e:.2e}' for n, (e, _) in vs_whole.items())
      + '; vs the D=1 plain versions: '
      + ', '.join(f'{n} {e:.2e}' for n, (e, _) in vs_plain.items()))
  return records


# Phase 13: expected-risk (MWER) fine-tuning; 13b: forced alignment.
MWER_SAMPLES = 4
MWER_NLL_WEIGHT = 0.1
MWER_SEED = 21
# Step 1 kernel vs plain is judged at these seeds (the steps draw from
# MWER_SEED + step).
MWER_CHECK_SEEDS = (MWER_SEED, MWER_SEED + 100)


def step_grad_errors(paths, got, want):
  """(the largest |want|, [(|got - want|max, |want|max, |got|max, path)]
  per leaf, each over that largest)."""
  largest = max(w.abs().max().item() for w in want)
  return largest, [((a - b).abs().max().item() / largest,
                    b.abs().max().item() / largest,
                    a.abs().max().item() / largest, path)
                   for path, a, b in zip(paths, got, want)]


def judge_step_grads(rows, what):
  """``step_grad_errors``' rows: each leaf within STEP_GRAD_RTOL of the
  largest gradient."""
  for diff, _, _, path in rows:
    check(diff <= STEP_GRAD_RTOL,
          f'{what}: gradient of {path} {diff:.3g} of the largest')


def mwer_objective(torch, risk, model, params, batch, generator):
  """``gnat.risk_train_step``'s objective before its update: estimator
  'mwer' over MWER_SAMPLES posterior samples a row, plus MWER_NLL_WEIGHT
  times the mean NLL of the feasible rows; the encoder runs once and the
  cache is shared. Returns (total, the sampler's aux, nll)."""
  frames, num_frames, labels, num_labels = batch
  lattice = model.lattice
  encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  cache = lattice.build_cache(params['lattice'])
  er, aux = risk.sampled_risk_loss(
      lattice, params['lattice'], encoded, num_frames, labels, num_labels,
      generator, num_samples=MWER_SAMPLES, estimator='mwer', cache=cache)
  per_seq = lattice(params['lattice'], frames=encoded, num_frames=num_frames,
                    labels=labels, num_labels=num_labels, cache=cache)
  finite = torch.isfinite(per_seq)
  nll = torch.where(finite, per_seq, 0.0).sum() / finite.sum().clamp(min=1)
  return er.mean() + MWER_NLL_WEIGHT * nll, aux, nll


@contextlib.contextmanager
def sampler_tap(torch, lattice, record, replay=None, log_partition=None,
                force_log_z_grad=None):
  """Instance patches of a lattice inside the block. Records the labels and
  log_prob that the sampler (``_sample_paths``, which the risk loss calls)
  returns and the log Z of its beta pass into ``record``; with ``replay``
  (labels), it returns those paths instead of drawing, scored by the beta
  pass and ``_score_paths`` (whatever joint+head pair is in use); with
  ``force_log_z_grad`` set, the beta pass records autograd or not as it
  says, whatever the caller asks; with ``log_partition``, the loss's log Z runs it
  in place of the kernels."""
  sample_paths, betas = lattice._sample_paths, lattice._sample_betas

  def betas_tap(*args):
    out = betas(*args)
    record['log_z'] = out[0].detach()
    return out

  def sample_tap(params, frames, num_frames, generator, num_samples, cache,
                 log_z_grad=True):
    if force_log_z_grad is not None:
      log_z_grad = force_log_z_grad
    if replay is None:
      labels, num, log_prob = sample_paths(params, frames, num_frames,
                                           generator, num_samples, cache,
                                           log_z_grad=log_z_grad)
    else:
      labels = replay
      with torch.set_grad_enabled(torch.is_grad_enabled() and log_z_grad):
        log_z, _, _ = lattice._sample_betas(params, cache, frames,
                                            num_frames)
      log_prob = lattice._score_paths(params, cache, frames, num_frames,
                                      labels) - log_z[:, None]
      num = (lattice.alignment.num_states() * num_frames.int())[:, None]
    record['labels'], record['log_prob'] = labels, log_prob.detach()
    return labels, num, log_prob

  lattice._sample_betas, lattice._sample_paths = betas_tap, sample_tap
  if log_partition is not None:
    lattice._forward_backward = lambda params, cache, frames, num_frames: (
        log_partition(params['weight_fn'], cache, frames, num_frames,
                      max_expansions=lattice.alignment.max_expansions,
                      frame_dependent=False, compute_dtype=torch.bfloat16))
  try:
    yield record
  finally:
    for name in ('_sample_betas', '_sample_paths', '_forward_backward'):
      lattice.__dict__.pop(name, None)


def busy_idle(spans):
  """(device busy ms, idle share of the first-to-last-kernel window,
  kernels) of ``device_spans``' spans."""
  busy, end = 0.0, spans[0][0]
  for start, stop, _ in spans:
    busy += max(0.0, stop - max(start, end))
    end = max(end, stop)
  return busy / 1e3, 1 - busy / (end - spans[0][0]), len(spans)


def slot_checks(torch, labels, num_frames, vocab, num_align):
  """Sampled labels inside [0, V], zero past each row's frames."""
  check(int(labels.min()) >= 0 and int(labels.max()) <= vocab,
        'sampled labels outside [0, V]')
  slot = torch.arange(labels.shape[-1], device=labels.device)
  padding = slot[None, None, :] >= num_align * num_frames[:, None, None]
  check(not bool(labels[padding.expand_as(labels)].any()),
        'sampled padding slots are not 0')


def peaked_drift(torch, lattice, params, frames, num_frames, scale):
  """sum exp(log_prob) over the distinct paths of 256 samples of a lattice
  whose heads are scaled by ``scale`` (peaked: the samples cover the
  posterior's mass), per row: 1 when the beta pass and the scoring
  normalize alike. Returns (the sums, the distinct paths' counts, the
  largest |log Z|, whose float32 rounding bounds what the sums resolve)."""
  wf = dict(params['weight_fn'])
  for name in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b'):
    wf[name] = wf[name] * scale
  peaked = dict(params, weight_fn=wf)
  with torch.no_grad():
    labels, _, log_prob = lattice.sample_paths(
        peaked, frames, num_frames,
        torch.Generator(device='cuda').manual_seed(5), num_samples=256)
    log_z = lattice._sample_betas(peaked, lattice.build_cache(peaked),
                                  frames, num_frames)[0]
  sums, distinct = [], []
  for row in range(labels.shape[0]):
    paths, index = torch.unique(labels[row], dim=0, return_inverse=True)
    first = torch.full((len(paths),), -1, dtype=torch.long, device='cuda')
    first.scatter_reduce_(0, index, torch.arange(len(index), device='cuda'),
                          'amax', include_self=True)
    sums.append(log_prob[row, first].double().exp().sum().item())
    distinct.append(len(paths))
  return sums, distinct, log_z.abs().max().item()


def phase_mwer(torch, gnat, presets, risk, lattices, fused_scan, joint_head,
               numerator_scan, viterbi, trigram_scan, sharded_scan, pytree):
  """Phase 13: the expected-risk (MWER) main path. gnat_global_bigram() at
  full width, phase 6's utterances, MWER_SAMPLES samples a row, estimator
  'mwer', NLL weight MWER_NLL_WEIGHT. Step 1's objective through the
  kernels (the sampler's beta pass runs the float32 joint+head forward each
  frame, without autograd: the loss's gradient through log Z is zero; the
  NLL term the bigram 'cache' pair) against the same objective through the
  plain versions on the same drawn paths, at MWER_CHECK_SEEDS; at the first
  also with the beta pass differentiated (forward, its recompute and
  backward a frame); then 3 ``risk_train_step`` steps, each counted and
  profiled, and one more without the profiler; the sampler's pieces alone;
  the share of equal slots when both routes draw from one seed; the drift
  of sum exp(log_prob) on a peaked lattice. Returns ({kernel: launches of
  the 3 steps}, the joint+head records' float32 numbers)."""
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  batch = tp_batch(torch, config)
  frames, num_frames, labels, num_labels = batch
  max_t, num_align, vocab = frames.shape[1], config.max_expansions + 1, (
      config.vocab_size)
  lattice = model.lattice
  params = state.params
  leaves = pytree.tree_leaves(params)
  generator = lambda seed: torch.Generator(device='cuda').manual_seed(seed)
  modules = (joint_head, fused_scan, numerator_scan, viterbi, trigram_scan,
             sharded_scan)

  # Step 1's objective through the kernels and through the plain versions
  # on the paths the kernels' run drew, at each of MWER_CHECK_SEEDS; at the
  # first, also through the kernels with the beta pass differentiated (the
  # JAX package's route: the gradient it adds is an exact zero).
  plain_lp = bigram_route(torch, fused_scan, config, len(NUM_FRAMES))['plain']
  paths = [pytree.keystr(path) for path, _ in
           pytree.tree_flatten_with_path(params)[0]]
  for seed in MWER_CHECK_SEEDS:
    t0 = time.perf_counter()
    reset_counts(*modules)
    torch.cuda.reset_peak_memory_stats()
    record = {}
    objective = lambda: mwer_objective(torch, risk, model, params, batch,
                                       generator(seed))[0]
    with sampler_tap(torch, lattice, record):
      loss_k, grads_k = loss_and_grads(torch, leaves, objective)
    peak_k = torch.cuda.max_memory_allocated() / 2**30
    launched = counts(joint_head), counts(fused_scan)
    check(lattice.last_path == 'kernel',
          f'the NLL term took {lattice.last_path!r}, not the kernels')
    check((joint_head.forward_launches, joint_head.backward_launches) ==
          (max_t, 0),
          f'step 1 launched the joint+head kernels {counts(joint_head)}, '
          f'not ({max_t}, 0)')
    check(fused_scan.forward_launches >= 1 and
          fused_scan.backward_launches >= 1,
          f'step 1 did not launch the log-partition pair: '
          f'{counts(fused_scan)}')
    plain = {}
    reset_counts(*modules)
    with joint_head.using(joint_head.joint_head_forward_plain,
                          joint_head.joint_head_backward_plain), sampler_tap(
                              torch, lattice, plain, replay=record['labels'],
                              log_partition=plain_lp):
      loss_p, grads_p = loss_and_grads(torch, leaves, objective)
    check(not any(v for m in modules for v in counts(m).values()),
          f'the plain route launched kernels: '
          f'{[counts(m) for m in modules]}')
    # Absolute, in nats: 8 float32 roundings of the largest |log Z|.
    tol = long_rtol(plain['log_z'])
    scale = plain['log_z'].abs().max().item()
    z_err = (record['log_z'] - plain['log_z']).abs().max().item()
    lp_err = (record['log_prob'] - plain['log_prob']).abs().max().item()
    lp_max = record['log_prob'].max().item()
    check(bool(torch.isfinite(record['log_z']).all()) and z_err <= tol,
          f'sampler log Z: kernel vs plain {z_err:.3g} nats (> {tol:.3g})')
    check(bool(torch.isfinite(record['log_prob']).all()) and lp_err <= tol,
          f'log_prob: kernel vs plain {lp_err:.3g} nats (> {tol:.3g})')
    check(lp_max <= tol, f'log_prob above 0: {lp_max}')
    slot_checks(torch, record['labels'], num_frames, vocab, num_align)
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    check(np.isfinite(loss_k) and loss_rel <= STEP_LOSS_RTOL,
          f'MWER step-1 objective {loss_k} through the kernels, {loss_p} '
          'plain')
    check(all(bool(torch.isfinite(g).all()) for g in grads_k),
          'a step-1 gradient is not finite')
    largest, rows = step_grad_errors(paths, grads_k, grads_p)
    say('mwer', f'seed {seed}: step 1 through the kernels vs plain versions '
        f'on the same {MWER_SAMPLES} paths a row: objective {loss_k:.6g} vs '
        f'{loss_p:.6g} (rel {loss_rel:.2e}); sampler log Z max |a-b| '
        f'{z_err:.3e} and log_prob {lp_err:.3e} nats, |log Z| up to '
        f'{scale:.5g} (tolerance {tol:.3e} nats); log_prob in '
        f'[{record["log_prob"].min().item():.6g}, {lp_max:.4g}]; gradients '
        f'of {len(leaves)} leaves against the largest {largest:.4g}, the '
        'worst four as |a-b|, |plain|, |kernel|: ' + '; '.join(
            f'{path} {d:.2e}, {ref:.2e}, {got:.2e}'
            for d, ref, got, path in sorted(rows, reverse=True)[:4]) +
        f'; kernel launches (joint+head, log-partition) {launched}; peak '
        f'memory {peak_k:.2f} GiB ({time.perf_counter() - t0:.1f} s)')
    judge_step_grads(rows, f'MWER step-1 (seed {seed}) kernel vs plain')
    if seed != MWER_SEED:
      continue
    kernel, loss_1 = record, loss_k
    attached = {}
    reset_counts(*modules)
    with sampler_tap(torch, lattice, attached, force_log_z_grad=True):
      loss_a, grads_a = loss_and_grads(torch, leaves, objective)
    check(torch.equal(attached['labels'], record['labels']) and
          abs(loss_a - loss_k) <= 1e-6 * abs(loss_k), f'the differentiated beta pass changed the '
          f'paths or the objective ({loss_a} vs {loss_k})')
    check((joint_head.forward_launches, joint_head.backward_launches) ==
          (2 * max_t, max_t),
          f'the differentiated beta pass launched the joint+head kernels '
          f'{counts(joint_head)}, not ({2 * max_t}, {max_t})')
    _, rows = step_grad_errors(paths, grads_k, grads_a)
    say('mwer', 'the same step with the beta pass differentiated (2 x '
        f'{max_t} joint+head forwards, {max_t} backwards): gradients vs '
        'the step\'s, the worst four as |a-b|, |differentiated|, |step|: '
        + '; '.join(f'{path} {d:.2e}, {ref:.2e}, {got:.2e}'
                    for d, ref, got, path in sorted(rows, reverse=True)[:4]))
    judge_step_grads(rows, 'MWER step 1 without vs with the beta pass '
                     'differentiated')

  # Both routes drawing from one seed: the share of equal slots.
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    drawn_k = lattice.sample_paths(params['lattice'], encoded, num_frames,
                                   generator(MWER_SEED),
                                   num_samples=MWER_SAMPLES)[0]
    with joint_head.using(joint_head.joint_head_forward_plain,
                          joint_head.joint_head_backward_plain):
      drawn_p = lattice.sample_paths(params['lattice'], encoded, num_frames,
                                     generator(MWER_SEED),
                                     num_samples=MWER_SAMPLES)[0]
  valid = (torch.arange(drawn_k.shape[-1], device='cuda')[None, None, :] <
           num_align * num_frames[:, None, None]).expand_as(drawn_k)
  same = (drawn_k == drawn_p)[valid].float().mean().item()
  paths_same = (drawn_k == drawn_p).all(-1).float().mean().item()
  check(torch.equal(drawn_k, kernel['labels']),
        'the no-grad draw differs from the step\'s draw on one seed')
  emitted = (drawn_k > 0).sum(-1).float()
  say('mwer', f'one seed, both routes drawing: {same:.6%} of the valid '
      f'slots and {paths_same:.1%} of the paths equal (not judged); labels '
      f'a sampled path {emitted.mean().item():.1f} on average (reference '
      f'{num_labels.float().mean().item():.1f})')

  # The main path: 3 risk_train_steps, counted, each profiled; one more
  # without the profiler.
  metrics_list, per_step, lines = [], [], []
  total = {}
  for step in range(TRAIN_STEPS + 1):
    reset_counts(*modules)
    torch.cuda.reset_peak_memory_stats()
    record = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def one():
      start.record()
      out = gnat.risk_train_step(
          model, optimizer, state, *batch, generator(MWER_SEED + step),
          num_samples=MWER_SAMPLES, estimator='mwer',
          nll_weight=MWER_NLL_WEIGHT)
      end.record()
      return out

    with sampler_tap(torch, lattice, record):
      if step < TRAIN_STEPS:
        (state, metrics), spans = device_spans(torch, one)
        busy, idle, kernels = busy_idle(spans)
      else:
        state, metrics = one()
        torch.cuda.synchronize()
    wall = start.elapsed_time(end)
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {f'{m.__name__.split(".")[-1]}.{n}': v
                for m in modules for n, v in counts(m).items() if v}
    metrics = {k: v.item() for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in metrics.values()),
          f'MWER step {step + 1} metrics not finite: {metrics}')
    check(lattice.last_path == 'kernel',
          f'MWER step {step + 1}: last_path {lattice.last_path!r}')
    check((joint_head.forward_launches, joint_head.backward_launches) ==
          (max_t, 0) and fused_scan.forward_launches >= 1 and
          fused_scan.backward_launches >= 1,
          f'MWER step {step + 1} launches {launches}')
    check(set(launches) <= {'joint_head.forward_launches',
                            'fused_scan.forward_launches',
                            'fused_scan.backward_launches'},
          f'MWER step {step + 1} launched kernels off its path: {launches}')
    slot_checks(torch, record['labels'], num_frames, vocab, num_align)
    if step == 0:
      check(torch.equal(record['labels'], kernel['labels']) and
            abs(metrics['loss'] - loss_1) <= 1e-6 * abs(loss_1),
            f'risk_train_step 1: loss {metrics["loss"]} vs the objective\'s '
            f'{loss_1} (paths equal: '
            f'{torch.equal(record["labels"], kernel["labels"])})')
    if step < TRAIN_STEPS:
      for name, v in launches.items():
        total[name] = total.get(name, 0) + v
      per_step.append(launches)
      metrics_list.append(metrics)
      lines.append(f'step {step + 1}: loss {metrics["loss"]:.6g}, mean_risk '
                   f'{metrics["mean_risk"]:.4g}, nll {metrics["nll"]:.6g}; '
                   f'wall {wall:.1f} ms (profiler on), device busy '
                   f'{busy:.1f} ms, idle {idle:.1%}, {kernels} kernels; peak '
                   f'{peak:.2f} GiB; launches {launches}')
    else:
      lines.append(f'step {step + 1} without the profiler: loss '
                   f'{metrics["loss"]:.6g}, wall {wall:.1f} ms, peak '
                   f'{peak:.2f} GiB')
  for line in lines:
    say('mwer', line)

  # The sampler's pieces alone on the step's encoded frames.
  lattice_params = params['lattice']
  encoded = model.encoder.apply(params['encoder'], frames, num_frames).detach()
  cache = lattice.build_cache(lattice_params)

  with torch.no_grad():
    beta_pass = lambda: lattice._sample_betas(lattice_params, cache, encoded,
                                              num_frames)
    _, betas_next, conts = beta_pass()
  noise = lattices._gumbel_source(generator(7), (len(NUM_FRAMES),), 'cuda')
  draw = lambda: lattice._draw_paths(lattice_params, cache, encoded,
                                     num_frames, betas_next, conts,
                                     MWER_SAMPLES, noise)
  drawn = draw()

  def scoring():
    lattice._score_paths(lattice_params, cache, encoded, num_frames,
                         drawn).sum().backward()

  def nll_term():
    lattice(lattice_params, encoded, num_frames, labels, num_labels,
            cache.detach()).sum().backward()

  parts = {}
  for name, fn in (('beta pass (no autograd)', torch.no_grad()(beta_pass)),
                   ('draw', draw), ('scoring forward+backward', scoring),
                   ('NLL term forward+backward', nll_term)):
    t = time.perf_counter()
    _, parts[name] = timed(torch, fn)
    parts[name] = (parts[name], (time.perf_counter() - t) * 1e3)
  for leaf in leaves:
    leaf.grad = None
  # The scoring's slot states: FullNGram's closed-form walk against the
  # generic per-slot loop it overrides, on the drawn paths.
  ctx = lattice.context
  closed, closed_ms = timed(torch, lambda: ctx.walk_states(drawn))
  looped, loop_ms = timed(torch,
                          lambda: super(type(ctx), ctx).walk_states(drawn))
  check(torch.equal(closed, looped),
        'FullNGram.walk_states differs from the generic walk')
  say('mwer', 'the step\'s parts alone (CUDA events; host clock): ' + ', '.join(
      f'{n} {ms:.1f} ms ({host:.1f})' for n, (ms, host) in parts.items()) +
      f'; the scoring\'s slot states of {tuple(drawn.shape)} paths: '
      f'closed-form walk {closed_ms:.2f} ms, generic loop {loop_ms:.1f} ms')

  # The float32 joint+head pair at the beta pass's per-frame shape.
  rng = np.random.default_rng(13)
  inputs, g_blank, g_lexical = joint_head_inputs(torch, rng, len(NUM_FRAMES),
                                                 config.vocab_size + 1,
                                                 config.vocab_size,
                                                 config.hidden_size)
  head = [inputs[n] for n in ('pc', 'pf', 'vocab_w', 'blank_w')]
  f32 = torch.float32
  calls = {
      'fwd': lambda: joint_head.joint_head_forward(**inputs,
                                                   compute_dtype=f32),
      'bwd': lambda: joint_head.joint_head_backward(*head, g_blank, g_lexical,
                                                    compute_dtype=f32),
      'fwd_plain': lambda: joint_head.joint_head_forward_plain(
          **inputs, compute_dtype=f32),
      'bwd_plain': lambda: joint_head.joint_head_backward_plain(
          *head, g_blank, g_lexical, compute_dtype=f32)}
  calls['fwd_library'], calls['bwd_library'] = joint_head_library(
      torch, inputs, g_blank, g_lexical, f32)
  times = {}
  for name, fn in calls.items():
    fn()
    times[name] = timed(torch, fn, repeats=20)[1]
  errors = max_errors(torch, calls['fwd'](), calls['fwd_plain'](),
                      JH_VALUE_NAMES, JH_RTOL['float32'])
  errors.update(max_errors(torch, calls['bwd'](), calls['bwd_plain'](),
                           JH_GRAD_NAMES, JH_RTOL['float32']))
  flops = 2.0 * len(NUM_FRAMES) * (config.vocab_size + 1) * (
      config.hidden_size) * (config.vocab_size + 1)
  fwd_bytes = nbytes(*inputs.values()) + nbytes(*calls['fwd']())
  bwd_bytes = nbytes(*head, g_blank, g_lexical) + nbytes(*calls['bwd']())
  f32_numbers = {
      'forward': {'mwer_f32_ms': times['fwd'],
                  'mwer_f32_plain_ms': times['fwd_plain'],
                  'mwer_f32_library_ms': times['fwd_library'],
                  'mwer_f32_bound_ms': bound(flops, fwd_bytes, 'float32')[0]},
      'backward': {'mwer_f32_ms': times['bwd'],
                   'mwer_f32_plain_ms': times['bwd_plain'],
                   'mwer_f32_library_ms': times['bwd_library'],
                   'mwer_f32_bound_ms': bound(2 * flops, bwd_bytes,
                                              'float32')[0]}}
  say('mwer', f'float32 joint+head at the beta pass\'s shape B=8 S=1025 '
      f'V=1024 h=512 (the step runs the forward; the backward runs on the '
      f'differentiated route above): forward kernel {times["fwd"]:.3f} ms, '
      f'plain {times["fwd_plain"]:.3f} ms, library (tanh + addmm) '
      f'{times["fwd_library"]:.3f} ms, bound '
      f'{f32_numbers["forward"]["mwer_f32_bound_ms"]:.3f} ms; backward '
      f'kernel {times["bwd"]:.3f} ms, plain {times["bwd_plain"]:.3f} ms, '
      f'library (mm, tanh derivative, mm) {times["bwd_library"]:.3f} ms, '
      f'bound {f32_numbers["backward"]["mwer_f32_bound_ms"]:.3f} ms; vs '
      'plain: ' + ', '.join(f'{n} {e:.2e}' for n, (e, _) in errors.items()))

  # The drift of sum exp(log_prob) on a peaked lattice (2 rows of 6
  # frames), the model's float32 weight function and a bfloat16 one (the
  # beta pass's kernel rounds its joint and head where the scoring's
  # einsums round theirs).
  short = encoded[:2, :6].contiguous()
  short_frames = torch.tensor([6, 6], device='cuda')
  bf16_lattice = type(lattice)(
      lattice.context, lattice.alignment, lambda ctx: lattice.weight_fn_cacher,
      lambda ctx: dataclasses.replace(lattice.weight_fn,
                                      compute_dtype=torch.bfloat16))
  drift = []
  for name, lat in (('float32', lattice), ('bfloat16', bf16_lattice)):
    for route, pair in (('kernel', None),
                        ('plain', (joint_head.joint_head_forward_plain,
                                   joint_head.joint_head_backward_plain))):
      with (contextlib.nullcontext() if pair is None else
            joint_head.using(*pair)):
        sums, distinct, log_z = peaked_drift(torch, lat, lattice_params,
                                             short, short_frames, 150.0)
      drift.append(f'{name} {route}: ' + ', '.join(
          f'{x - 1:+.3e} ({d} paths)' for x, d in zip(sums, distinct)) +
          f', |log Z| {log_z:.5g} (float32 resolves {log_z * 2**-24:.1e})')
  say('mwer', 'peaked lattice (heads x150, 2 rows of 6 frames, 256 samples): '
      'sum exp(log_prob) over the distinct paths, minus 1: ' +
      '; '.join(drift))
  return total, f32_numbers


def align_rescore(torch, blank_w, lex_w, emit, num_frames, num_labels):
  """The float64 weight of the FrameLabelDependent alignment that emits
  label u at frame emit[u], from the string weights [T, B, U+1]: at each
  frame its labels in order, then the blank at the position reached."""
  blank_w, lex_w = blank_w.double(), lex_w.double()
  max_t, batch = blank_w.shape[:2]
  u = emit.shape[1]
  live = torch.arange(u, device='cuda')[None, :] < num_labels[:, None]
  rows = torch.arange(batch, device='cuda')[:, None]
  lex = lex_w[emit.long().clamp(min=0), rows, torch.arange(u, device='cuda')]
  t = torch.arange(max_t, device='cuda')
  reached = ((emit[:, None, :] <= t[None, :, None]) & live[:, None, :]).sum(-1)
  blank = blank_w[t[None, :], rows, reached]  # [B, T]
  valid = t[None, :] < num_frames[:, None]
  return (torch.where(live, lex, 0.0).sum(-1) +
          torch.where(valid, blank, 0.0).sum(-1))


def align_checks(torch, lattice, semirings, lattice_params, cache, encoded,
                 num_frames, labels, num_labels, emit, scores, what):
  """emit frames inside [0, num_frames), non-decreasing, -1 past
  num_labels; the score the MaxTropical string DP's value and the float64
  rescoring of the returned alignment. Returns (the rescoring's max
  relative difference, the string weights)."""
  u = labels.shape[1]
  live = torch.arange(u, device='cuda')[None, :] < num_labels[:, None]
  check(emit.dtype == torch.int32 and tuple(emit.shape) == tuple(labels.shape),
        f'{what}: emit_frames {emit.dtype} {tuple(emit.shape)}')
  check(bool((emit[~live] == -1).all()), f'{what}: emit past num_labels')
  check(bool(((emit >= 0) & (emit < num_frames[:, None]))[live].all()),
        f'{what}: emit frames outside [0, num_frames)')
  check(bool((emit[:, 1:] >= emit[:, :-1])[live[:, 1:]].all()),
        f'{what}: emit frames decreasing')
  check(bool(torch.isfinite(scores).all()), f'{what}: infeasible scores')
  with torch.no_grad():
    blank_w, lex_w = lattice._string_weights(lattice_params, cache, encoded,
                                             labels)
    dp = lattice._string_dp(blank_w, lex_w, num_frames, num_labels,
                            semirings.MaxTropical)
  scale = scores.abs().clamp(min=1.0)
  dp_rel = ((scores - dp).abs() / scale).max().item()
  check(dp_rel <= F32_RTOL, f'{what}: score vs the string DP {dp_rel:.3g}')
  rescored = align_rescore(torch, blank_w, lex_w, emit, num_frames,
                           num_labels)
  rel = ((scores.double() - rescored).abs() / scale.double()).max().item()
  check(rel <= F32_RTOL, f'{what}: score vs the float64 rescoring of its '
        f'alignment {rel:.3g}')
  return rel, (blank_w, lex_w)


def phase_align(torch, gnat, presets, numerator_scan, semirings, modules):
  """Phase 13b: forced alignment of phase 6's utterances and label
  sequences, gnat_global_bigram() (string weights from
  ``JointWeightFn.label_weights``, no lattice kernel) and
  hat_bigram(vocab_size=1024) (the numerator forward kernel, float32),
  both at full width with random weights from seed 0. Checked:
  ``align_checks``; the HAT run against the same call through the
  numerator's plain versions (scores to F32_RTOL; rows whose emit frames
  differ must tie in the float64 rescoring). Returns the numerator forward
  launches of the HAT align."""
  results = {}
  for name, config in (('gnat_global_bigram', presets.gnat_global_bigram()),
                       ('hat_bigram', presets.hat_bigram(vocab_size=1024))):
    model = gnat.GNATModel(config, device='cuda')
    params = model.init(torch.Generator().manual_seed(0))
    frames, num_frames, labels, num_labels = tp_batch(torch, config)
    lattice, lattice_params = model.lattice, params['lattice']
    with torch.no_grad():
      encoded = model.encoder.apply(params['encoder'], frames, num_frames)
      cache = lattice.build_cache(lattice_params)
    align = lambda: lattice.align(lattice_params, encoded, num_frames, labels,
                                  num_labels, cache=cache)
    align()  # warm-up
    reset_counts(*modules)
    (emit, scores), ms = timed(torch, align)
    launched = {f'{m.__name__.split(".")[-1]}.{n}': v
                for m in modules for n, v in counts(m).items() if v}
    rel, weights = align_checks(torch, lattice, semirings, lattice_params,
                                cache, encoded, num_frames, labels,
                                num_labels, emit, scores, name)
    line = (f'{name} B={len(NUM_FRAMES)} T_max={max(NUM_FRAMES)} '
            f'U_max={max(NUM_LABELS)}: align {ms:.1f} ms, launches '
            f'{launched or "none"}; scores in [{scores.min().item():.6g}, '
            f'{scores.max().item():.6g}], float64 rescoring within '
            f'{rel:.2e}')
    if name == 'hat_bigram':
      check(set(launched) == {'numerator_scan.forward_launches'},
            f'the HAT align launched {launched}, not the numerator forward '
            'kernel alone')
      # The timed call's launches (align_checks recomputes the weights).
      results['launches'] = launched['numerator_scan.forward_launches']
      wf = lattice.weight_fn
      wf.label_weights = lambda p, c, f, s, n: numerator_scan.label_weights(
          wf.weight_fn, p, c, f, s, n, hat=True,
          forward=numerator_scan.numerator_forward_plain,
          backward=numerator_scan.numerator_backward_plain)
      try:
        align()
        (emit_p, scores_p), ms_p = timed(torch, align)
      finally:
        del wf.label_weights
      scale = scores_p.abs().clamp(min=1.0)
      score_rel = ((scores - scores_p).abs() / scale).max().item()
      check(score_rel <= F32_RTOL,
            f'HAT align scores: kernel vs plain {score_rel:.3g}')
      differ = (emit != emit_p).any(-1)
      if bool(differ.any()):
        a = align_rescore(torch, *weights, emit, num_frames, num_labels)
        b = align_rescore(torch, *weights, emit_p, num_frames, num_labels)
        tie = ((a - b).abs() / scale.double())[differ].max().item()
        check(tie <= F32_RTOL, f'HAT align: emit frames differ from plain '
              f'in rows {differ.nonzero()[:, 0].tolist()} and do not tie '
              f'({tie:.3g})')
      line += (f'; plain versions {ms_p:.1f} ms, scores within '
               f'{score_rel:.2e}, emit frames equal in '
               f'{int((~differ).sum())} of {len(differ)} rows')
    else:
      check(not launched, f'the GN align launched {launched}')
    say('align', line)
    del model, params, encoded, cache
  return results['launches']


# Phase 14: the CTC topology (S = 1) and path entropy.
# Bench config 11's batch (bench.py:357-365): 32 utterances of 1600 frames
# and 100 labels.
CTC_GN_BATCH, CTC_GN_FRAMES, CTC_GN_LABELS = 32, 1600, 100
# Path entropy at hat_bigram(vocab_size=1024): phase 6's utterances cut to a
# quarter of their length (depth cut, width not), 400 frames at most.
ENTROPY_NUM_FRAMES = [n // 4 for n in NUM_FRAMES]
# Bench config 4 (bench.py:296-307): B=16, T=400, V=64, h=emb=feature=128,
# FrameDependent, locally normalized bigram, bfloat16 head inputs.
CONFIG4 = dict(batch=16, frames=400, vocab=64, hidden=128)
# The CTC decode's second run lowers the trained blank bias by this much.
BLANK_SHIFT = 5.0
# Entropy, kernel against plain (float32, T <= 400) and the factorized
# route against the frame loop: log Z and log cost relative to
# max(|value|, 1), as LP_RTOL's float32 gradients.
ENTROPY_RTOL = 1e-4


def entropy_lift(torch, semirings):
  """The entropy lift of the JAX package (lattices.py:844, bench.py:302-305):
  w -> weighted(w, log max(-w, 1e-30)) in LogLogExpectation."""
  sr = semirings.LogLogExpectation
  return sr, lambda w: sr.weighted(w, torch.log(torch.clamp(-w, min=1e-30)))


def entropy_checks(torch, log_z, log_cost, num_frames, what, deficient):
  """A locally normalized lattice's (log Z, log cost): log Z within
  long_rtol of 0, or at most that above it where the lattice is
  ``deficient`` (FrameLabelDependent: the last expansion state has no
  lexical arc, so a frame's arcs sum to less than 1); the entropy exp(log
  cost - log Z) finite and positive on rows with frames. Returns the
  entropy."""
  check(bool(torch.isfinite(log_z).all()), f'{what}: log Z not finite')
  tol = long_rtol(log_cost)
  largest = log_z.max().item() if deficient else log_z.abs().max().item()
  check(largest <= tol, f'{what}: a locally normalized log Z reaches '
        f'{largest} (> {tol:.3g})')
  entropy = torch.exp(log_cost - log_z)
  real = num_frames > 0
  check(bool(torch.isfinite(entropy).all()) and
        bool((entropy[real] > 0).all()), f'{what}: entropy {entropy}')
  return entropy


def launched_by(modules):
  """{'module.counter': launches} of the counters that are not 0."""
  return {f'{m.__name__.split(".")[-1]}.{n}': v
          for m in modules for n, v in counts(m).items() if v}


def value_rel(torch, got, want):
  """max |got - want| / max(|want|, 1) over the leaves of two values."""
  return max(relative(torch, a, b).max().item() for a, b in zip(got, want))


def ctc_rescore(torch, lattice, lattice_params, cache, encoded, num_frames,
                labels):
  """Float64 weights of FrameDependent S = 1 alignments (slot format) under
  the lattice's float32 weights: blank or the label's lexical weight at
  each real frame."""
  with torch.no_grad():
    blank, lexical = lattice._s1_weights(lattice_params['weight_fn'], cache,
                                         encoded, tuple(num_frames.shape))
  labels = labels.long()
  lex = torch.gather(lexical.double(), -1,
                     (labels - 1).clamp(min=0)[..., None])[..., 0]
  w = torch.where(labels > 0, lex, blank.double())
  real = (torch.arange(labels.shape[1], device=labels.device)[None] <
          num_frames[:, None])
  return torch.where(real, w, 0.0).sum(-1)


def route(lattice, factorized, fn):
  """fn() with the lattice's S = 1 route on (the factorized one) or off
  (the generic frame loop); returns (fn(), last_path)."""
  lattice._factorize_s1 = factorized
  try:
    return fn(), lattice.last_path
  finally:
    lattice._factorize_s1 = True


def ctc_training(torch, gnat, presets, pytree, modules, card):
  """(a) CTC training and decode at full width; returns (model, params,
  batch)."""
  config = presets.ctc_like(vocab_size=1024)
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  batch = tp_batch(torch, config)
  frames, num_frames, labels, num_labels = batch
  lattice, params = model.lattice, state.params
  leaves = pytree.tree_leaves(params)
  objective = lambda: model.mean_loss(params, *batch)

  # Step 1 on both routes; the factorized one launches no kernel.
  route(lattice, True, lambda: loss_and_grads(torch, leaves, objective))
  reset_counts(*modules)
  (got, _), s1_ms = timed(torch, lambda: route(
      lattice, True, lambda: loss_and_grads(torch, leaves, objective)))
  launched = launched_by(modules)
  check(not launched, f'the factorized CTC step launched {launched}')
  (want, _), generic_ms = timed(torch, lambda: route(
      lattice, False, lambda: loss_and_grads(torch, leaves, objective)))
  say('ctc', 'ctc_like(1024) step 1, factorized route vs the generic '
      'frame loop: ' + compare_steps(torch, pytree, params, got, want,
                                     'ctc_like, factorized vs generic') +
      f'; loss+grad {s1_ms:.1f} ms vs {generic_ms:.1f} ms ({card})')

  # 3 AdamW steps, each timed with CUDA events and profiled.
  losses = []
  for step in range(TRAIN_STEPS):
    reset_counts(*modules)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def one():
      start.record()
      out = gnat.train_step(model, optimizer, state, *batch)
      end.record()
      return out

    (state, loss), spans = device_spans(torch, one)
    busy, idle, kernels = busy_idle(spans)
    wall = start.elapsed_time(end)
    launched = launched_by(modules)
    check(np.isfinite(loss.item()) and not launched,
          f'CTC step {step + 1}: loss {loss.item()}, launched {launched}')
    losses.append(loss.item())
    say('ctc', f'ctc_like(1024) train step {step + 1}: loss '
        f'{loss.item():.6g}, wall {wall:.1f} ms (profiler on), device busy '
        f'{busy:.1f} ms, idle {idle:.1%}, {kernels} kernels, peak '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})')
  check(losses[-1] < losses[0], f'CTC losses do not fall: {losses}')

  # The decode on both routes, float32; rows whose labels differ must tie.
  # The model after 3 steps emits blank everywhere; a copy with its blank
  # bias lowered by BLANK_SHIFT emits labels too.
  report_decode(torch, lattice, 'ctc_like(1024) decode',
                lambda: model.decode(state.params, frames, num_frames),
                state.params, frames, num_frames, model, card, None)
  shifted = {**state.params, 'lattice': pytree.tree_map(
      lambda x: x.detach(), state.params['lattice'])}
  shifted['lattice']['weight_fn']['blank_b'] = (
      shifted['lattice']['weight_fn']['blank_b'] - BLANK_SHIFT)
  report_decode(torch, lattice, f'ctc_like(1024) decode, blank bias -'
                f'{BLANK_SHIFT}',
                lambda: model.decode(shifted, frames, num_frames), shifted,
                frames, num_frames, model, card, 1)
  return model, state.params, batch


def report_decode(torch, lattice, what, decode, params, frames, num_frames,
                  model, card, least_labels):
  """Times ``decode`` on both S = 1 routes and holds them together: path
  weights to F32_RTOL, the factorized alignment rescored in float64 to its
  weight, rows whose labels differ tied in the rescoring; at least
  ``least_labels`` labels emitted (None: any number)."""
  decode()  # warm-up
  (out_s1, path), s1_ms = timed(torch, lambda: route(lattice, True, decode))
  check(path == 's1', f'the CTC decode took {path!r}')
  (out_g, _), generic_ms = timed(torch, lambda: route(lattice, False,
                                                      decode))
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    lattice_params = params['lattice']
    cache = lattice.build_cache(lattice_params)
  rescored = [ctc_rescore(torch, lattice, lattice_params, cache, encoded,
                          num_frames, out[0]) for out in (out_s1, out_g)]
  check(torch.equal(out_s1[1], out_g[1]), 'num_alignment_labels differ')
  rel = relative(torch, out_s1[2], out_g[2])
  check(rel.max().item() <= F32_RTOL,
        f'CTC path weights differ by {rel.max().item():.3g} relative')
  own = relative(torch, rescored[0], out_s1[2])
  check(own.max().item() <= F32_RTOL,
        f'the factorized decode rescores {own.max().item():.3g} from its '
        'path weight')
  tied = [b for b in range(len(NUM_FRAMES))
          if not torch.equal(out_s1[0][b], out_g[0][b])]
  tie_rel = relative(torch, rescored[0], rescored[1])
  for b in tied:
    check(tie_rel[b].item() <= F32_RTOL,
          f'CTC decode row {b}: labels differ and the paths score apart')
  emitted = (out_s1[0] > 0).sum().item()
  check(least_labels is None or emitted >= least_labels,
        f'{what}: {emitted} labels emitted')
  differ = int(((out_s1[0] != out_g[0]) & (out_s1[0] + out_g[0] > 0)).sum())
  say('ctc', f'{what} B={len(NUM_FRAMES)} T_max={max(NUM_FRAMES)}: '
      f'factorized {s1_ms:.1f} ms, generic {generic_ms:.1f} ms ({card}); '
      f'weights max rel {rel.max().item():.2e}, rescored max rel '
      f'{own.max().item():.2e}, '
      + ('labels equal' if not tied else
         f'{differ} slots differ, on rows {tied}, whose two alignments '
         f'rescore within {max(tie_rel[b].item() for b in tied):.2e} '
         'relative') + f', {emitted} labels emitted')


def ctc_global(torch, gnat, presets, pytree, modules, card):
  """(b) Bench config 11's lattice through gnat_global_bigram(
  context_size=0): the loss at B=32 x 1600, against the generic route at
  B=8, label_marginals at B=8."""
  config = presets.gnat_global_bigram(context_size=0)
  model = gnat.GNATModel(config, device='cuda')
  params = model.init(torch.Generator().manual_seed(0))
  leaves = pytree.tree_leaves(params)
  for leaf in leaves:
    leaf.requires_grad_(True)
  lattice = model.lattice
  rng = np.random.default_rng(11)
  big = (torch.from_numpy(rand(rng, (CTC_GN_BATCH, CTC_GN_FRAMES,
                                     config.feature_size))).cuda(),
         torch.full((CTC_GN_BATCH,), CTC_GN_FRAMES, device='cuda'),
         torch.from_numpy(rng.integers(
             1, config.vocab_size + 1,
             size=(CTC_GN_BATCH, CTC_GN_LABELS))).cuda(),
         torch.full((CTC_GN_BATCH,), CTC_GN_LABELS, device='cuda'))
  model_loss = lambda: loss_and_grads(
      torch, leaves, lambda: model.mean_loss(params, *big))
  model_loss()  # warm-up
  reset_counts(*modules)
  torch.cuda.reset_peak_memory_stats()
  (loss, _), model_ms = timed(torch, model_loss)
  peak = torch.cuda.max_memory_allocated() / 2**30
  launched = launched_by(modules)
  check(lattice.last_path == 's1' and not launched and np.isfinite(loss),
        f'config 11 loss: path {lattice.last_path!r}, launched {launched}, '
        f'loss {loss}')
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], big[0], big[1])
  lattice_leaves = pytree.tree_leaves(params['lattice'])
  lattice_loss = lambda: loss_and_grads(
      torch, lattice_leaves, lambda: lattice(params['lattice'], encoded,
                                             *big[1:]).mean())
  lattice_loss()  # warm-up
  torch.cuda.reset_peak_memory_stats()
  _, lattice_ms = timed(torch, lattice_loss)
  lattice_peak = torch.cuda.max_memory_allocated() / 2**30
  real = CTC_GN_BATCH * CTC_GN_FRAMES
  say('ctc', f'gnat_global_bigram(context_size=0) (config 11) B='
      f'{CTC_GN_BATCH} T={CTC_GN_FRAMES} U={CTC_GN_LABELS}: mean loss '
      f'{loss:.6g}; model loss+grad {model_ms:.1f} ms '
      f'({real / model_ms * 1e3:.0f} frames/s, peak {peak:.2f} GiB), '
      f'lattice loss+grad alone {lattice_ms:.1f} ms '
      f'({real / lattice_ms * 1e3:.0f} frames/s, peak {lattice_peak:.2f} '
      f'GiB) ({card})')
  del big, encoded

  # B=8, the lattice loss on the encoder's output: the factorized route
  # against the generic one in float32 and in float64. At T=1600 the
  # float32 frame loop's backward algorithm drifts on the blank head, whose
  # gradient is a structural zero here (every path takes each frame's one
  # blank weight once): the gradients are judged against float64.
  batch = tp_batch(torch, config)
  frames, num_frames = batch[:2]
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  lattice_params = params['lattice']
  params64 = pytree.tree_map(lambda x: x.detach().double().requires_grad_(),
                             lattice_params)
  leaves64 = pytree.tree_leaves(params64)

  def lattice_step(p, leaves_, x, factorized):
    objective = lambda: lattice(p, x, *batch[1:]).mean()
    run = lambda: route(lattice, factorized,
                        lambda: loss_and_grads(torch, leaves_, objective))
    if factorized:
      run()  # warm-up (the generic routes' frame loops time their first call)
    return timed(torch, run)

  ((got, path), s1_ms) = lattice_step(lattice_params, lattice_leaves,
                                      encoded, True)
  check(path == 's1', f'the config 11 loss took {path!r}')
  ((generic, path), generic_ms) = lattice_step(lattice_params,
                                               lattice_leaves, encoded, False)
  check(path == 'generic', f'the generic config 11 loss took {path!r}')
  ((want, _), _) = lattice_step(params64, leaves64, encoded.double(), False)
  loss_rel = abs(got[0] - generic[0]) / abs(generic[0])
  check(loss_rel <= STEP_LOSS_RTOL,
        f'config 11 loss, factorized {got[0]} vs generic {generic[0]}')
  paths = [pytree.keystr(path) for path, _ in
           pytree.tree_flatten_with_path(lattice_params)[0]]
  _, rows = step_grad_errors(paths, got[1], [g.float() for g in want[1]])
  judge_step_grads(rows, 'config 11, factorized vs float64')
  _, generic_rows = step_grad_errors(paths, generic[1],
                                     [g.float() for g in want[1]])
  worst, worst_generic = max(rows), max(generic_rows)
  say('ctc', f'gnat_global_bigram(context_size=0) lattice B='
      f'{len(NUM_FRAMES)} T_max={max(NUM_FRAMES)}: loss factorized '
      f'{got[0]:.7g}, generic {generic[0]:.7g} (rel {loss_rel:.2e}), '
      f'float64 {want[0]:.7g}; gradients against float64: factorized '
      f'within {worst[0]:.2e} of the largest ({worst[3]}), the generic '
      f'float32 route {worst_generic[0]:.2e} ({worst_generic[3]}); '
      f'loss+grad {s1_ms:.1f} ms vs {generic_ms:.1f} ms ({card})')

  # label_marginals at B=8 on both routes; FLD(2): one blank per frame.
  marginals = lambda: lattice.label_marginals(params['lattice'], encoded,
                                              num_frames)
  marginals()  # warm-up
  ((bm, lp), path), s1_ms = timed(torch, lambda: route(lattice, True,
                                                      marginals))
  check(path == 's1', f'config 11 label_marginals took {path!r}')
  ((bm_g, lp_g), _), generic_ms = timed(torch, lambda: route(
      lattice, False, marginals))
  # Float32 log-space rounding over the frames before and after each one,
  # as phase 10 bounds its generic posteriors: at most exp(+-worst).
  with torch.no_grad():
    log_z = lattice.shortest_distance(lattice_params, encoded, num_frames)
  worst = max(NUM_FRAMES) * 2.0**-24 * log_z.abs().max().item()
  drift, ratio = posterior_checks(torch, bm, lp, num_frames,
                                  config.max_expansions, worst,
                                  long_rtol(log_z))
  generic_drift = blank_drift(torch, bm_g, num_frames)
  diff = max((bm - bm_g).abs().max().item(), (lp - lp_g).abs().max().item())
  check(diff <= math.expm1(2 * worst),
        f'config 11 posteriors: factorized vs generic {diff}')
  say('ctc', f'gnat_global_bigram(context_size=0) label_marginals B='
      f'{len(NUM_FRAMES)} T_max={max(NUM_FRAMES)}: factorized {s1_ms:.1f} ms, '
      f'generic {generic_ms:.1f} ms ({card}); blank sums within '
      f'exp(+-{drift:.2e}) of 1 (generic {generic_drift:.2e}, worst case '
      f'{worst:.3g}), label sums at most {ratio:.4f} blank sums, factorized '
      f'vs generic max abs diff {diff:.2e}')


def ctc_entropy(torch, gnat, presets, lattices, contexts, alignments,
                weight_fns, semirings, joint_head, modules, card, ctc):
  """(c) Path entropy: hat_bigram(vocab_size=1024) at full width (the
  joint+head forward kernel once a frame, counted, against its plain
  version), bench config 4's shape, and the CTC model of (a) at S = 1
  against its generic route. Returns the joint+head forward launches."""
  sr, lift = entropy_lift(torch, semirings)

  # hat_bigram(1024), float32: S=1025 >= 1024 states, the kernel's gate.
  config = presets.hat_bigram(vocab_size=1024)
  model = gnat.GNATModel(config, device='cuda')
  params = model.init(torch.Generator().manual_seed(0))
  rng = np.random.default_rng(14)
  num_frames = torch.tensor(ENTROPY_NUM_FRAMES, device='cuda')
  frames = torch.from_numpy(rand(rng, (len(ENTROPY_NUM_FRAMES),
                                       max(ENTROPY_NUM_FRAMES),
                                       config.feature_size))).cuda()
  lattice = model.lattice
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    cache = lattice.build_cache(params['lattice'])

  def entropy():
    with torch.no_grad():
      return lattice.shortest_distance(params['lattice'], encoded,
                                       num_frames, semiring=sr, cache=cache,
                                       weight_lift=lift)

  entropy()  # warm-up
  reset_counts(*modules)
  torch.cuda.reset_peak_memory_stats()
  (log_z, log_cost), ms = timed(torch, entropy)
  peak = torch.cuda.max_memory_allocated() / 2**30
  launches = joint_head.forward_launches
  launched = launched_by(modules)
  _, spans = device_spans(torch, entropy)
  busy, idle, kernels = busy_idle(spans)
  check(launches == max(ENTROPY_NUM_FRAMES) and
        set(launched) == {'joint_head.forward_launches'},
        f'hat_bigram entropy launched {launched}, not '
        f'{max(ENTROPY_NUM_FRAMES)} joint+head forwards')
  check(lattice.last_path == 'generic',
        f'hat_bigram entropy took {lattice.last_path!r}')
  ent = entropy_checks(torch, log_z, log_cost, num_frames, 'hat_bigram',
                       deficient=True)
  with joint_head.using(joint_head.joint_head_forward_plain,
                        joint_head.joint_head_backward_plain):
    entropy()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (log_z_p, log_cost_p), plain_ms = timed(torch, entropy)
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
  rel = value_rel(torch, (log_z, log_cost), (log_z_p, log_cost_p))
  check(rel <= ENTROPY_RTOL,
        f'hat_bigram entropy, kernel vs plain: {rel:.3g} relative')
  real = sum(ENTROPY_NUM_FRAMES)
  say('ctc', f'path entropy hat_bigram(1024) B={len(ENTROPY_NUM_FRAMES)} '
      f'T_max={max(ENTROPY_NUM_FRAMES)}: joint+head kernel {ms:.1f} ms '
      f'({real / ms * 1e3:.0f} frames/s, peak {peak:.2f} GiB, {launches} '
      f'forward launches; profiled: device busy {busy:.1f} ms, idle '
      f'{idle:.1%}, {kernels} kernels), plain {plain_ms:.1f} ms (peak '
      f'{plain_peak:.2f} GiB) ({card}); entropy {ent.min().item():.4g}-'
      f'{ent.max().item():.4g} nats, log Z {log_z.min().item():.4g} to '
      f'{log_z.max().item():.4g} (FLD(2): deficient); kernel vs plain max '
      f'rel {rel:.2e}')
  del model, params, encoded, cache

  # Bench config 4's shape: a locally normalized bigram, 65 states (the
  # einsum route, no kernel).
  c4 = CONFIG4
  context = contexts.FullNGram(vocab_size=c4['vocab'], context_size=1)
  lattice4 = lattices.RecognitionLattice(
      context=context, alignment=alignments.FrameDependent(),
      weight_fn_cacher_factory=lambda ctx: weight_fns.SharedEmbCacher(
          num_context_states=ctx.shape()[0], embedding_size=c4['hidden']),
      weight_fn_factory=lambda ctx: weight_fns.LocallyNormalizedWeightFn(
          weight_fns.JointWeightFn(vocab_size=c4['vocab'],
                                   hidden_size=c4['hidden'],
                                   compute_dtype=torch.bfloat16)))
  params4 = lattice4.init(torch.Generator().manual_seed(4), c4['hidden'],
                          device='cuda')
  frames4 = torch.from_numpy(rand(rng, (c4['batch'], c4['frames'],
                                        c4['hidden']), 0.1)).cuda()
  num_frames4 = torch.full((c4['batch'],), c4['frames'], device='cuda')

  def entropy4():
    with torch.no_grad():
      return lattice4.shortest_distance(params4, frames4, num_frames4,
                                        semiring=sr, weight_lift=lift)

  entropy4()  # warm-up
  reset_counts(*modules)
  torch.cuda.reset_peak_memory_stats()
  (log_z4, log_cost4), ms4 = timed(torch, entropy4)
  peak4 = torch.cuda.max_memory_allocated() / 2**30
  launched = launched_by(modules)
  _, spans = device_spans(torch, entropy4)
  busy4, idle4, kernels4 = busy_idle(spans)
  check(not launched and lattice4.last_path == 'generic',
        f'config 4 entropy: {lattice4.last_path!r}, launched {launched}')
  ent4 = entropy_checks(torch, log_z4, log_cost4, num_frames4, 'config 4',
                        deficient=False)
  say('ctc', f'path entropy at config 4 (B={c4["batch"]} T={c4["frames"]} '
      f'V={c4["vocab"]} h={c4["hidden"]}, FD bigram, bf16 heads): '
      f'{ms4:.1f} ms ({c4["batch"] * c4["frames"] / ms4 * 1e3:.0f} '
      f'frames/s, peak {peak4:.2f} GiB; profiled: device busy {busy4:.1f} '
      f'ms, idle {idle4:.1%}, {kernels4} kernels) ({card}); entropy '
      f'{ent4.min().item():.4g}-{ent4.max().item():.4g} nats')

  # The CTC model of (a) at S = 1, factorized against the frame loop.
  model, params, (frames, num_frames, _, _) = ctc
  lattice = model.lattice
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  entropy1 = lambda: lattice.shortest_distance(
      params['lattice'], encoded, num_frames, semiring=sr, weight_lift=lift)
  with torch.no_grad():
    route(lattice, True, entropy1)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ((log_z1, log_cost1), path), s1_ms = timed(
        torch, lambda: route(lattice, True, entropy1))
    s1_peak = torch.cuda.max_memory_allocated() / 2**30
    check(path == 's1', f'the CTC entropy took {path!r}')
    ((log_z0, log_cost0), path), generic_ms = timed(
        torch, lambda: route(lattice, False, entropy1))
  ent1 = entropy_checks(torch, log_z1, log_cost1, num_frames, 'ctc_like',
                        deficient=False)
  rel = value_rel(torch, (log_z1, log_cost1), (log_z0, log_cost0))
  check(rel <= ENTROPY_RTOL,
        f'CTC entropy, factorized vs generic: {rel:.3g} relative')
  say('ctc', f'path entropy ctc_like(1024) B={len(NUM_FRAMES)} '
      f'T_max={max(NUM_FRAMES)}: factorized {s1_ms:.1f} ms (peak '
      f'{s1_peak:.2f} GiB), generic {generic_ms:.1f} ms ({card}); entropy '
      f'{ent1.min().item():.4g}-{ent1.max().item():.4g} nats; factorized '
      f'vs generic max rel {rel:.2e}')
  return launches


def phase_ctc(torch, gnat, presets, lattices, contexts, alignments,
              weight_fns, semirings, joint_head, pytree, modules):
  """Phase 14: the CTC topology (a single context state, S = 1) and path
  entropy. (a) ``ctc_like(vocab_size=1024)`` at full width on phase 6's
  utterances: step 1's loss and gradients on the factorized route against
  the generic frame loop, 3 AdamW train steps (CUDA events, profiled:
  device busy time, idle share; no kernel launched), a decode on both
  routes (float32; rows whose labels differ must tie in a float64
  rescoring). (b) Bench config 11's lattice, gnat_global_bigram(
  context_size=0): the mean loss and its gradients at B=32 x 1600, U=100,
  timed with and without the encoder; at B=8 against the generic route;
  label_marginals at B=8 (posterior sums; against the generic route).
  (c) Path entropy (LogLogExpectation, the entropy lift): hat_bigram(1024)
  at full width, B=8, T <= 400, through the joint+head forward kernel
  once a frame (counted) and through its plain version; bench config 4's
  shape (no kernel); the model of (a), factorized against generic. Every
  time is printed beside the card's name and power limit. Returns the
  joint+head forward launches of the entropy path."""
  card = card_line()
  ctc = ctc_training(torch, gnat, presets, pytree, modules, card)
  torch.cuda.empty_cache()
  ctc_global(torch, gnat, presets, pytree, modules, card)
  torch.cuda.empty_cache()
  return ctc_entropy(torch, gnat, presets, lattices, contexts, alignments,
                     weight_fns, semirings, joint_head, modules, card, ctc)


# Phase 15: streaming serving and the trainer.
STREAM_DATA = dict(batch_size=8, max_num_frames=1600, max_num_labels=100,
                   feature_size=80, vocab_size=1024)
# The streaming encoder against the offline one: JAX's own limit
# (tests/test_models.py:185-186).
STREAM_ATOL = 1e-4
STREAM_CHUNKS = (16, 64)
SERVE_CHUNK = 16
BEAM_SIZE, BEAM_MAX_LABELS = 4, 512
# Chunked beams against whole-utterance beams on the same frames: the carried
# state is exact, so only the order of float sums may differ.
BEAM_SCORE_RTOL = 1e-6
# The serving loop (chunked encoder) against the offline encode: the share of
# equal label slots, and a differing best hypothesis must tie (rescored).
EQUAL_SLOT_SHARE = 0.999
TIE_RTOL = 1e-4
FRAME_SHIFT_MS = 10.0  # assumed for the real-time factor
LONG_BATCH, LONG_FRAMES, LONG_LABELS = 8, 6400, 100


def cuda_batch(torch, batch):
  """(frames, num_frames, labels, num_labels) of a numpy batch, on the
  card."""
  return tuple(torch.from_numpy(batch[k]).cuda() for k in (
      'frames', 'num_frames', 'labels', 'num_labels'))


def assert_bit_equal(torch, pytree, got, want, what):
  """The parameters, AdamW moments and step counts of two train states
  equal bit for bit."""
  got_leaves = pytree.tree_leaves(got.params)
  want_leaves = pytree.tree_leaves(want.params)
  check(len(got_leaves) == len(want_leaves), f'{what}: tree differs')
  for a, b in zip(got_leaves, want_leaves):
    check(torch.equal(a, b), f'{what}: parameters differ')
    for field in ('exp_avg', 'exp_avg_sq', 'step'):
      check(torch.equal(got.opt_state.adamw.state[a][field],
                        want.opt_state.adamw.state[b][field]),
            f'{what}: AdamW {field} differs')
  check(got.step == want.step and got.opt_state.schedule.last_epoch ==
        want.opt_state.schedule.last_epoch, f'{what}: step counts differ')
  return len(got_leaves)


def streaming_trainer(torch, gnat, presets, train_lib, data_lib,
                      checkpoint_lib, fused_scan, viterbi, semirings, pytree):
  """Phase 15(a): ``train()`` of streaming_conformer_gnat() at full width
  on synthetic B=8 x 1600 batches: step 1 against the plain versions, 3
  steps with a checkpoint at 2 and 3 and an evaluation at 3, the restored
  state bit-equal to the saved one, a resumed run to step 4; and the
  prefetch thread's batches on the card against their host arrays. Returns
  (the trained state, the launches of the run's kernels by name)."""
  config = presets.streaming_conformer_gnat()
  data_config = train_lib.DataConfig(**STREAM_DATA)
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  batches = train_lib.synthetic_batches(data_config)
  next(batches)  # train() holds the first batch out for evaluation
  route = bigram_route(torch, fused_scan, config, STREAM_DATA['batch_size'])
  check(route['name'] == 'cache', f'planned {route["name"]!r}, not cache')
  loss_1 = step1_vs_plain(torch, pytree, semirings, model, state.params,
                          cuda_batch(torch, next(batches)), route,
                          'stream-train')
  del model, state

  with tempfile.TemporaryDirectory(prefix='chip_smoke_train_') as workdir:
    records = []
    reset_counts(fused_scan, viterbi)
    t0 = time.perf_counter()
    trained = train_lib.train(config, data_config, num_steps=3,
                              workdir=workdir, checkpoint_every=2,
                              eval_every=3, log_every=1, prefetch=2,
                              log_fn=records.append)
    seconds = time.perf_counter() - t0
    events = [json.loads(r) for r in records]
    for event in events:
      say('stream-train', f'train() step record {json.dumps(event)}')
    losses = [e['loss'] for e in events]
    check(len(events) == 3 and all(np.isfinite(losses)),
          f'train() records: {events}')
    check(abs(losses[0] - loss_1) <= 1e-4 * abs(loss_1) + 5e-5,
          f'train() step 1 loss {losses[0]} != the checked step 1 '
          f'{loss_1}')
    check('eval_label_accuracy' in events[-1], 'no evaluation at step 3')
    manager = checkpoint_lib.CheckpointManager(workdir)
    check(manager.all_steps() == [2, 3],
          f'checkpoints {manager.all_steps()}, not [2, 3]')
    fresh_model = gnat.GNATModel(config, device='cuda')
    template = gnat.init_train_state(fresh_model,
                                     torch.Generator().manual_seed(1),
                                     optimizer)
    restored = manager.restore(template=template)
    leaves = assert_bit_equal(torch, pytree, restored, trained,
                              'restored vs saved')
    del fresh_model, template, restored
    resumed = []
    train_lib.train(config, data_config, num_steps=4, workdir=workdir,
                    checkpoint_every=2, eval_every=3, log_every=1,
                    prefetch=2, log_fn=resumed.append)
    resumed = [json.loads(r) for r in resumed]
    check(resumed[0] == {'event': 'restored', 'step': 3},
          f'the resumed run printed {resumed[0]}, not the restored event')
    check(len(resumed) == 2 and resumed[1]['step'] == 4 and
          np.isfinite(resumed[1]['loss']), f'resumed records {resumed}')
    for event in resumed:
      say('stream-train', f'resumed train() record {json.dumps(event)}')
  launches = {'steps': (fused_scan.forward_launches,
                        fused_scan.backward_launches),
              'decode': viterbi.launches}
  check(all(count >= 4 for count in launches['steps']) and
        launches['decode'] >= 1, f'train() launches: {launches}')
  say('stream-train',
      f'streaming_conformer_gnat() B=8 T_max=1600 U_max=100: 3 train() '
      f'steps in {seconds:.1f} s (first call, with its checkpoints and '
      f'evaluation); restored step 3 bit-equal to the saved state '
      f'({leaves} leaves: parameters, AdamW moments and counts); resumed '
      f'to step 4, loss {resumed[1]["loss"]}; launches of the 4 steps '
      f'(forward, backward) {launches["steps"]}, of the evaluation\'s '
      f'decode {launches["decode"]}')

  # The prefetch thread's batches, staged on a side stream, against the
  # host arrays they came from; the consumer's stream works in between.
  host = train_lib.synthetic_batches(data_config)
  staged = data_lib.prefetch_to_device(train_lib.synthetic_batches(
      data_config), size=2, device='cuda')
  weight = torch.randn((STREAM_DATA['feature_size'], 4096), device='cuda')
  for _ in range(4):
    batch = next(staged)
    (batch['frames'] @ weight).sum().item()
    for key, value in next(host).items():
      check(batch[key].device.type == 'cuda' and
            np.array_equal(batch[key].cpu().numpy(), value),
            f'prefetched {key} differs from its host array')
  staged.close()
  say('stream-train', 'prefetch_to_device: 4 batches staged from the side '
                      'stream equal their host arrays')
  return trained, launches


def accumulate_check(torch, gnat, presets, train_lib, fused_scan, pytree):
  """Phase 15(b): make_optimizer(accumulate_steps=2) over two micro-batches
  of phase (a)'s data: no parameter moves after micro-step 1, the
  parameters move after micro-step 2, AdamW and the schedule count one
  update. Returns the micro-steps' log-partition launches."""
  config = presets.streaming_conformer_gnat()
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE, accumulate_steps=2)
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  batches = train_lib.synthetic_batches(train_lib.DataConfig(**STREAM_DATA))
  leaves = pytree.tree_leaves(state.params)
  before = [leaf.detach().clone() for leaf in leaves]
  reset_counts(fused_scan)
  state, loss_1 = gnat.train_step(model, optimizer, state,
                                  *cuda_batch(torch, next(batches)))
  check(all(torch.equal(a, b) for a, b in zip(leaves, before)),
        'a parameter moved after micro-step 1 of 2')
  state, loss_2 = gnat.train_step(model, optimizer, state,
                                  *cuda_batch(torch, next(batches)))
  moved = sum(not torch.equal(a, b) for a, b in zip(leaves, before))
  check(moved > 0, 'no parameter moved after micro-step 2 of 2')
  steps = {int(s['step']) for s in state.opt_state.adamw.state.values()}
  check(steps == {1} and state.opt_state.schedule.last_epoch == 1 and
        state.opt_state.mini_step == 0,
        f'AdamW steps {steps}, schedule at '
        f'{state.opt_state.schedule.last_epoch}: not one update')
  launches = (fused_scan.forward_launches, fused_scan.backward_launches)
  check(all(n >= 2 for n in launches), f'micro-step launches {launches}')
  say('stream-accumulate',
      f'accumulate_steps=2 on streaming_conformer_gnat(), B=8 x 1600 '
      f'micro-batches: losses {loss_1.item():.6g}, {loss_2.item():.6g}; no '
      f'parameter moved after micro-step 1; {moved} of {len(leaves)} leaves '
      f'moved after micro-step 2; one AdamW update; log-partition launches '
      f'(forward, backward) {launches}')
  return launches


def step1_vs_float64(torch, pytree, semirings, model, params, batch, route,
                     phase, sharded_scan):
  """Step 1 of a bigram GN model judged as phase 12 judges its step 1: the
  lattice loss on the encoder outputs through the kernels, through their
  float32 plain versions (``route``'s 'plain') and through the plain
  versions in float64 (``tp_lattice_loss`` on one shard with the float64
  frame reduction: the same bfloat16 roundings, float64 sums). Losses to
  STEP_LOSS_RTOL; each gradient (lattice leaves, encoder outputs) of the
  kernels within max(STEP_GRAD_RTOL, twice the float32 plain versions'
  error) of the float64 one, of the largest float64 gradient. Prints its
  line; returns the whole model's mean loss through the kernels."""
  frames, num_frames, labels, num_labels = batch
  lattice = model.lattice
  t0 = time.perf_counter()
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    loss_model = model.mean_loss(params, *batch).item()
  rest = (num_frames, labels, num_labels)

  def plain(p, e):
    cache = lattice.build_cache(p)
    log_z = route['plain'](
        p['weight_fn'], cache, e, num_frames,
        max_expansions=lattice.alignment.max_expansions,
        frame_dependent=False, compute_dtype=torch.bfloat16)
    return log_z - lattice._string_forward(p, cache, e, num_frames, labels,
                                           num_labels, semirings.Log)

  routes = {
      'kernels': (torch.float32, lambda p, e: lattice.loss(p, e, *rest)),
      'plain': (torch.float32, plain),
      'float64': (torch.float64, lambda p, e: sharded_scan.tp_lattice_loss(
          lattice, p, e, *rest,
          reduce=float64_frame_reduce(torch, sharded_scan))),
  }
  results = {}
  for name, (dtype, loss_fn) in routes.items():
    results[name] = lattice_step1(torch, pytree, params['lattice'], encoded,
                                  dtype, loss_fn)
    if name == 'kernels':
      check(lattice.last_path == 'kernel',
            f'last_path is {lattice.last_path!r}, not kernel')
  (loss_k, got), (loss_p, plain_grads), (loss_64, ref) = results.values()
  for what, loss in (('plain', loss_p), ('float64', loss_64)):
    rel = abs(loss_k - loss) / abs(loss)
    check(np.isfinite(loss_k) and rel <= STEP_LOSS_RTOL,
          f'step-1 loss {loss_k} through the kernels vs {loss} {what}')
  largest = max(g.abs().max().item() for g in ref.values())
  errors = {name: tuple((g[name] - r).abs().max().item() / largest
                        for g in (got, plain_grads))
            for name, r in ref.items()}
  for name, (err_k, err_p) in errors.items():
    check(bool(torch.isfinite(got[name]).all()), f'{name}: not finite')
    check(err_k <= max(STEP_GRAD_RTOL, 2 * err_p),
          f'step-1 gradient of {name}: kernels {err_k:.3g} of the largest '
          f'from float64, float32 plain {err_p:.3g}')
  vs_plain = max(((got[n] - plain_grads[n]).abs().max().item() / largest, n)
                 for n in ref)
  blank_b = "['weight_fn']['blank_b']"
  say(phase, f'step 1 (lattice loss on the encoder outputs): loss kernels '
             f'{loss_k:.9g}, float32 plain {loss_p:.9g}, float64 '
             f'{loss_64:.9g}; gradients vs float64, of the largest '
             f'{largest:.4g}, per leaf (kernels, float32 plain): ' +
             ', '.join(f'{n} ({a:.2e}, {b:.2e})'
                       for n, (a, b) in errors.items()) +
             f'; kernels vs float32 plain at most {vs_plain[0]:.2e} '
             f'({vs_plain[1]}); blank_b gradient kernels '
             f'{got[blank_b].item():.6g}, plain '
             f'{plain_grads[blank_b].item():.6g}, float64 '
             f'{ref[blank_b].item():.3g} ({time.perf_counter() - t0:.1f} s)')
  return loss_model


def rnn_cacher_check(torch, gnat, presets, fused_scan, viterbi, semirings,
                     pytree, sharded_scan):
  """Phase 15(c): gnat_global_bigram(use_rnn_cacher=True) at full width on
  phase 6's batch: step 1 against the plain versions in float32 and float64
  (``step1_vs_float64``: kernels against plain read 2.77e-3 of the largest
  gradient on FLD's structurally zero blank_b, PR 17), 3 train steps through
  the 'cache' pair (losses falling), one profiled; a decode through the
  Viterbi kernel. Returns ((forward, backward) launches, decode
  launches)."""
  config = presets.gnat_global_bigram(use_rnn_cacher=True)
  route = bigram_route(torch, fused_scan, config, len(NUM_FRAMES))
  check(route['name'] == 'cache', f'planned {route["name"]!r}, not cache')
  model, _, state, batch, launches = train_and_check(
      torch, gnat, semirings, pytree, config, NUM_FRAMES, NUM_LABELS,
      'rnn-cacher', route, step1=functools.partial(
          step1_vs_float64, sharded_scan=sharded_scan))
  reset_counts(viterbi)
  (labels, num_labels, weights), decode_ms = timed(
      torch, lambda: model.decode(state.params, batch[0], batch[1]))
  check(model.lattice.last_path == 'kernel' and viterbi.launches >= 1,
        f'the RNN-cacher decode took {model.lattice.last_path!r}')
  check(bool(torch.isfinite(weights).all()) and
        torch.equal(num_labels, 3 * batch[1].int()) and
        int(labels.max()) <= config.vocab_size, 'RNN-cacher decode output')
  say('rnn-cacher', f'SharedRNNCacher (LSTM {config.embedding_size} over '
                    f'{config.vocab_size + 1} bigram states) decode B='
                    f'{len(NUM_FRAMES)} T_max={max(NUM_FRAMES)} through the '
                    f'Viterbi kernel: '
                    f'{decode_ms:.1f} ms (first call), {viterbi.launches} '
                    f'launches')
  return launches, viterbi.launches


def latency_line(times):
  return (f'p50 {np.percentile(times, 50):.2f} ms, p90 '
          f'{np.percentile(times, 90):.2f} ms')


def streaming_encoder_check(torch, encoder_lib, trained, encoder, card):
  """Phase 15(d): StreamingEncoder on phase 6's lengths with the
  parameters trained in (a), in chunks of 16 and 64 frames against the
  offline (auto: banded) encode; banded against dense attention at B=8 x
  1600, outputs and gradients, each route's peak memory. Returns (frames,
  num_frames, the offline encodings)."""
  params = pytree_detach(torch, trained.params['encoder'])
  rng = np.random.default_rng(15)
  frames = torch.from_numpy(rand(rng, (len(NUM_FRAMES), max(NUM_FRAMES),
                                       encoder.feature_size))).cuda()
  num_frames = torch.tensor(NUM_FRAMES, device='cuda')
  mask = (torch.arange(frames.shape[1], device='cuda')[None] <
          num_frames[:, None])
  check(encoder.attention_inputs(mask)[0], 'the offline encode is not banded')
  with torch.no_grad():
    offline = encoder.apply(params, frames, num_frames)
    stream = encoder_lib.StreamingEncoder(encoder)
    for chunk in STREAM_CHUNKS:
      state = stream.init_state(len(NUM_FRAMES))
      outs = []
      for start in range(0, frames.shape[1], chunk):
        state, out = stream.step(params, state,
                                 frames[:, start:start + chunk])
        outs.append(out)
      err = (torch.cat(outs, dim=1) - offline).abs()[mask].max().item()
      check(err <= STREAM_ATOL, f'chunks of {chunk}: the streaming encoder '
            f'differs from the offline one by {err:.3g}')
      say('stream-encoder', f'StreamingEncoder chunks of {chunk} frames vs '
                            f'the offline (banded) encode, B=8 T_max=1600: '
                            f'max |a-b| {err:.3g} over valid frames '
                            f'(limit {STREAM_ATOL})')

  results = {}
  weights = torch.linspace(-1.0, 1.0, encoder.model_size, device='cuda')
  for banded in (True, False):
    routed = dataclasses.replace(encoder, banded_attention=banded)
    leaves = pytree_detach(torch, params)
    for leaf in torch.utils._pytree.tree_leaves(leaves):
      leaf.requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = routed.apply(leaves, frames, num_frames)
    (out * weights).sum().backward()
    end.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grads = [leaf.grad for leaf in torch.utils._pytree.tree_leaves(leaves)]
    results[banded] = (out.detach(), grads, peak, start.elapsed_time(end))
    del out
  out_err = (results[True][0] - results[False][0]).abs().max().item()
  largest = max(g.abs().max().item() for g in results[False][1])
  grad_err = max((a - b).abs().max().item()
                 for a, b in zip(results[True][1], results[False][1]))
  check(out_err <= STREAM_ATOL, f'banded vs dense outputs {out_err:.3g}')
  check(grad_err <= STREAM_ATOL * largest,
        f'banded vs dense gradients {grad_err:.3g} of largest {largest:.3g}')
  say('stream-encoder',
      f'banded vs dense attention, encoder 4 x 256 (4 heads, window 64, '
      f'conv 8) B=8 T=1600 forward+backward: outputs max |a-b| '
      f'{out_err:.3g}, gradients max |a-b| {grad_err / largest:.3g} of the '
      f'largest {largest:.3g}; peak memory above the inputs banded '
      f'{results[True][2] / 2**20:.1f} MiB vs dense '
      f'{results[False][2] / 2**20:.1f} MiB; time (first call) banded '
      f'{results[True][3]:.1f} ms, dense {results[False][3]:.1f} ms; {card}')
  return frames, num_frames, offline


def pytree_detach(torch, tree):
  return torch.utils._pytree.tree_map(lambda x: x.detach().clone(), tree)


def run_greedy(torch, greedy, lattice_params, cache, encoded, num_frames,
               chunk):
  """The greedy decoder over ``encoded`` in chunks: (final states, labels,
  counts)."""
  q = greedy.init_state(encoded.shape[0])
  labels, counts = [], 0
  for start in range(0, encoded.shape[1], chunk):
    valid = torch.clamp(num_frames - start, 0, chunk)
    q, out, n = greedy.step(lattice_params, q,
                            encoded[:, start:start + chunk], valid, cache)
    labels.append(out)
    counts = counts + n
  return q, torch.cat(labels, dim=1), counts


def run_beam(torch, beam, lattice_params, cache, encoded, num_frames, chunk):
  """The beam decoder's final state over ``encoded`` in chunks."""
  state = beam.init_state(encoded.shape[0])
  for start in range(0, encoded.shape[1], chunk):
    valid = torch.clamp(num_frames - start, 0, chunk)
    state = beam.step(lattice_params, state,
                      encoded[:, start:start + chunk], valid, cache)
  return state


def check_beams_equal(torch, got, want, what):
  for field in ('context', 'labels', 'num_labels', 'hash'):
    check(torch.equal(got[field], want[field]), f'{what}: beam {field}')
  finite = torch.isfinite(want['score'])
  check(torch.equal(finite, torch.isfinite(got['score'])) and
        torch.equal(got['score'][~finite], want['score'][~finite]),
        f'{what}: beam scores differ in their -inf slots')
  rel = ((got['score'][finite] - want['score'][finite]).abs() /
         want['score'][finite].abs().clamp(min=1e-30)).max().item()
  check(rel <= BEAM_SCORE_RTOL, f'{what}: beam scores rel {rel:.3g}')
  return rel


def serving_loop(torch, encoder_lib, streaming, encoder, enc_params,
                 lattice, lattice_params, cache, frames, num_frames):
  """The serving loop: each chunk of SERVE_CHUNK frames through the
  streaming encoder, then the greedy and the beam decoders, timed per step
  with CUDA events and synchronised per chunk as a server reading its
  results would be. Returns (greedy output, beam state, {step: [ms per
  chunk]})."""
  stream = encoder_lib.StreamingEncoder(encoder)
  greedy = streaming.StreamingGreedyDecoder(lattice)
  beam = streaming.StreamingBeamDecoder(lattice, BEAM_SIZE, BEAM_MAX_LABELS)
  batch = frames.shape[0]
  es = stream.init_state(batch)
  q, beams = greedy.init_state(batch), beam.init_state(batch)
  labels, counts, times = [], 0, {'encoder': [], 'greedy': [], 'beam': []}
  events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
  with torch.no_grad():
    for start in range(0, frames.shape[1], SERVE_CHUNK):
      valid = torch.clamp(num_frames - start, 0, SERVE_CHUNK)
      events[0].record()
      es, encoded = stream.step(enc_params, es,
                                frames[:, start:start + SERVE_CHUNK])
      events[1].record()
      q, out, n = greedy.step(lattice_params, q, encoded, valid, cache)
      events[2].record()
      beams = beam.step(lattice_params, beams, encoded, valid, cache)
      events[3].record()
      torch.cuda.synchronize()
      for key, (a, b) in zip(times, zip(events, events[1:])):
        times[key].append(a.elapsed_time(b))
      labels.append(out)
      counts = counts + n
  return (q, torch.cat(labels, dim=1), counts), beams, times


def decoders_check(torch, encoder_lib, streaming, encoder, lattice, trained,
                   frames, num_frames, offline, card):
  """Phase 15(e): the greedy and beam (4, max_labels 512, 'max') decoders
  (the trained model with its blank bias lowered by BLANK_SHIFT) on one
  offline encode, in chunks of 16 and in one chunk: identical;
  nbest_offline's best equals the one-chunk beam's; the serving loop
  (chunked encoder -> chunked decoders) against the offline encode ->
  one-chunk decoders: equal label slots >= 99.9%, a differing best
  hypothesis a tie when rescored; per-chunk latency, launches per chunk
  and the real-time factor."""
  lattice_params = pytree_detach(torch, trained.params['lattice'])
  # Three steps leave the model emitting no label: lower the blank bias, as
  # phase 14 does, so that the decoders emit (and recombine) labels.
  lattice_params['weight_fn']['blank_b'] -= BLANK_SHIFT
  enc_params = pytree_detach(torch, trained.params['encoder'])
  cache = lattice.build_cache(lattice_params)
  greedy = streaming.StreamingGreedyDecoder(lattice)
  beam = streaming.StreamingBeamDecoder(lattice, BEAM_SIZE, BEAM_MAX_LABELS)
  max_t = offline.shape[1]
  t0 = time.perf_counter()
  g_whole = run_greedy(torch, greedy, lattice_params, cache, offline,
                       num_frames, max_t)
  b_whole = run_beam(torch, beam, lattice_params, cache, offline, num_frames,
                     max_t)
  torch.cuda.synchronize()
  whole_s = time.perf_counter() - t0
  g_chunks = run_greedy(torch, greedy, lattice_params, cache, offline,
                        num_frames, SERVE_CHUNK)
  b_chunks = run_beam(torch, beam, lattice_params, cache, offline,
                      num_frames, SERVE_CHUNK)
  for got, want, name in zip(g_chunks, g_whole,
                             ('states', 'labels', 'counts')):
    check(torch.equal(got, want), f'greedy chunks of {SERVE_CHUNK} vs one '
          f'chunk: {name} differ')
  rel = check_beams_equal(torch, b_chunks, b_whole,
                          f'beam chunks of {SERVE_CHUNK} vs one chunk')
  lexical = int((g_whole[1] > 0).sum())
  best_labels, best_n, best_score = beam.best(b_whole)
  check(lexical > 0, 'the greedy decode emitted no label')
  say('stream-decode', f'one offline encode (B=8 T_max=1600), greedy and '
                       f'beam {BEAM_SIZE} (max_labels {BEAM_MAX_LABELS}, '
                       f"merge 'max'): chunks of {SERVE_CHUNK} vs one chunk "
                       f'identical (greedy labels, counts, states; beam '
                       f'labels, counts, states, hashes; scores rel '
                       f'{rel:.2g}); greedy emitted {lexical} labels, beam '
                       f'best {best_n.tolist()} labels; one-chunk pair '
                       f'{whole_s:.1f} s')

  with warnings_caught() as caught:
    n_labels, n_num, n_scores = streaming.nbest_offline(
        lattice, lattice_params, offline, num_frames, beam_size=BEAM_SIZE,
        cache=cache)
  check(any('capped at 512' in str(w.message) for w in caught),
        'nbest_offline did not warn of its 512-label cap')
  check(torch.equal(n_labels[:, 0], best_labels) and
        torch.equal(n_num[:, 0], best_n) and
        torch.equal(n_scores[:, 0], best_score),
        "nbest_offline's best differs from the one-chunk beam's")
  finite = torch.isfinite(n_scores)
  check(bool((n_scores[:, :-1] >= n_scores[:, 1:])[finite[:, 1:]].all()),
        'nbest_offline scores not sorted')
  say('stream-decode', f'nbest_offline (beam {BEAM_SIZE}, default labels '
                       f'capped at 512 with its warning): best equals the '
                       f'one-chunk beam, scores sorted')

  # The serving loop, timed per chunk, against the offline path.
  serve_greedy, serve_beam, times = serving_loop(
      torch, encoder_lib, streaming, encoder, enc_params, lattice,
      lattice_params, cache, frames, num_frames)
  slots = 3 * num_frames
  valid = (torch.arange(g_whole[1].shape[1], device='cuda')[None] <
           slots[:, None])
  share = (serve_greedy[1] == g_whole[1])[valid].float().mean().item()
  check(share >= EQUAL_SLOT_SHARE, f'serving loop vs offline: greedy slots '
        f'equal {share:.4%}')
  s_labels, s_n, s_score = beam.best(serve_beam)
  width = torch.maximum(s_n, best_n)
  used = (torch.arange(BEAM_MAX_LABELS, device='cuda')[None] <
          width[:, None])
  beam_share = ((s_labels == best_labels) | ~used).all(dim=1)
  slot_share = ((s_labels == best_labels)[used].float().mean().item()
                if bool(used.any()) else 1.0)
  ties = []
  for b in (~beam_share).nonzero()[:, 0].tolist():
    # Rescore both best hypotheses on the offline encode: their best
    # alignments' weights (forced alignment, MaxTropical).
    hyps = torch.stack([s_labels[b], best_labels[b]])
    counts = torch.stack([s_n[b], best_n[b]])
    _, rescored = lattice.align(lattice_params, offline[b:b + 1].expand(
        2, -1, -1), num_frames[b:b + 1].expand(2), hyps, counts, cache=cache)
    gap = abs(rescored[0].item() - rescored[1].item())
    ties.append((b, gap / abs(rescored[1].item())))
    check(gap <= TIE_RTOL * abs(rescored[1].item()),
          f'serving loop vs offline: stream {b} best hypothesis differs and '
          f'its rescoring {rescored.tolist()} is no tie')
  check(slot_share >= EQUAL_SLOT_SHARE,
        f'serving loop vs offline: beam best slots equal {slot_share:.4%}')
  say('stream-decode', f'serving loop (chunked encoder -> chunked decoders) '
                       f'vs offline encode -> one-chunk decoders: greedy '
                       f'label slots equal {share:.4%}, beam best slots '
                       f'equal {slot_share:.4%} ({int(beam_share.sum())} of '
                       f'{len(beam_share)} streams identical; differing '
                       f'streams rescored as ties: {ties})')

  # Per-chunk latency and launches: one chunk of each step under the
  # profiler.
  stream = encoder_lib.StreamingEncoder(encoder)
  chunk_frames = offline[:, :SERVE_CHUNK]
  valid = torch.clamp(num_frames, 0, SERVE_CHUNK)
  with torch.no_grad():
    es = stream.init_state(frames.shape[0])
    per_chunk = {
        'encoder': launch_count(torch, lambda: stream.step(
            enc_params, es, frames[:, :SERVE_CHUNK])),
        'greedy': launch_count(torch, lambda: greedy.step(
            lattice_params, greedy.init_state(frames.shape[0]),
            chunk_frames, valid, cache)),
        'beam': launch_count(torch, lambda: beam.step(
            lattice_params, beam.init_state(frames.shape[0]), chunk_frames,
            valid, cache)),
    }
  audio_ms = SERVE_CHUNK * FRAME_SHIFT_MS
  p50 = {k: float(np.percentile(v, 50)) for k, v in times.items()}
  say('stream-latency',
      f'per chunk of {SERVE_CHUNK} frames, B=8, {len(times["encoder"])} '
      f'chunks (CUDA events, synchronised per chunk): encoder step '
      f'{latency_line(times["encoder"])}, greedy step '
      f'{latency_line(times["greedy"])}, beam {BEAM_SIZE} step '
      f'{latency_line(times["beam"])}; device activities per chunk '
      f'{json.dumps(per_chunk)}; real-time factor, assuming a '
      f'{FRAME_SHIFT_MS:.0f} ms frame shift ({audio_ms:.0f} ms of audio a '
      f'chunk), at the p50s: encoder+greedy '
      f'{(p50["encoder"] + p50["greedy"]) / audio_ms:.3f}, encoder+beam '
      f'{(p50["encoder"] + p50["beam"]) / audio_ms:.3f}; {card}')


@contextlib.contextmanager
def warnings_caught():
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter('always')
    yield caught


def launch_count(torch, fn):
  """The device activities (kernels, copies, sets) of one call of fn."""
  _, spans = device_spans(torch, fn)
  return len(spans)


def long_step(torch, gnat, presets, fused_scan, card):
  """Phase 15(f): one train_step at B=8 x T=6400 (U=100) with the JAX
  package's production encoder (benchmarks/tpu_production_step.py:39-48:
  512 x 4, 8 heads, ffn 2048, bfloat16) through the banded route: its
  time, peak memory and log-partition mode. Returns (mode, (forward,
  backward) launches)."""
  config = presets.streaming_conformer_gnat(
      encoder_size=512, encoder_layers=4, encoder_heads=8,
      encoder_ffn_size=2048, hidden_size=512, embedding_size=512)
  model = gnat.GNATModel(config, device='cuda')
  model.encoder = dataclasses.replace(
      model.encoder, banded_attention=True, dtype=torch.bfloat16)
  optimizer = gnat.make_optimizer()
  state = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                optimizer)
  rng = np.random.default_rng(1)
  frames = torch.from_numpy(rand(rng, (LONG_BATCH, LONG_FRAMES, 80),
                                 0.5)).cuda()
  num_frames = torch.full((LONG_BATCH,), LONG_FRAMES, device='cuda')
  labels = torch.from_numpy(rng.integers(
      1, config.vocab_size + 1, size=(LONG_BATCH, LONG_LABELS))).cuda()
  num_labels = torch.full((LONG_BATCH,), LONG_LABELS, device='cuda')
  mode = fused_scan.plan(LONG_BATCH, config.vocab_size + 1,
                         config.vocab_size, torch.bfloat16)
  reset_counts(fused_scan)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  (state, loss), step_ms = timed(torch, lambda: gnat.train_step(
      model, optimizer, state, frames, num_frames, labels, num_labels))
  peak = torch.cuda.max_memory_allocated()
  names = LP_COUNTERS[mode]
  launches = tuple(getattr(fused_scan, n) for n in names)
  check(np.isfinite(loss.item()) and model.lattice.last_path == 'kernel' and
        all(n >= 1 for n in launches),
        f'long step: loss {loss.item()}, path {model.lattice.last_path}, '
        f'launches {launches}')
  say('stream-long', f'train_step B={LONG_BATCH} T={LONG_FRAMES} '
                     f'U={LONG_LABELS}, streaming Conformer 512 x 4 (8 '
                     f'heads, ffn 2048, bfloat16, banded attention, window '
                     f'64): {step_ms:.1f} ms (first call), peak memory '
                     f'{peak / 2**30:.2f} GiB, loss {loss.item():.6g}; '
                     f"log-partition mode {mode!r} (plan for 'auto'), "
                     f'launches (forward, backward) {launches}; {card}')
  return mode, launches


def phase_streaming(torch, gnat, presets, encoder_lib, streaming, train_lib,
                    data_lib, checkpoint_lib, fused_scan, viterbi,
                    sharded_scan, semirings, pytree):
  """Phase 15: streaming serving and the trainer, (a)-(f) above. Returns
  {kernel counter: {path: launches}} of the new paths."""
  card = card_line()
  t0 = time.perf_counter()
  trained, train_launches = streaming_trainer(
      torch, gnat, presets, train_lib, data_lib, checkpoint_lib, fused_scan,
      viterbi, semirings, pytree)
  say('stream-train', f'{time.perf_counter() - t0:.1f} s')
  torch.cuda.empty_cache()
  accumulate = accumulate_check(torch, gnat, presets, train_lib, fused_scan,
                                pytree)
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  rnn_launches, rnn_decodes = rnn_cacher_check(
      torch, gnat, presets, fused_scan, viterbi, semirings, pytree,
      sharded_scan)
  say('rnn-cacher', f'{time.perf_counter() - t0:.1f} s')
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  model = gnat.GNATModel(presets.streaming_conformer_gnat(), device='cuda')
  frames, num_frames, offline = streaming_encoder_check(
      torch, encoder_lib, trained, model.encoder, card)
  say('stream-encoder', f'{time.perf_counter() - t0:.1f} s')
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  decoders_check(torch, encoder_lib, streaming, model.encoder, model.lattice,
                 trained, frames, num_frames, offline, card)
  say('stream-decode', f'{time.perf_counter() - t0:.1f} s')
  del trained, frames, offline
  torch.cuda.empty_cache()
  t0 = time.perf_counter()
  mode, long_launches = long_step(torch, gnat, presets, fused_scan, card)
  say('stream-long', f'{time.perf_counter() - t0:.1f} s')
  train_path = 'streaming_conformer_gnat train() steps (3, resumed to 4)'
  accumulate_path = ('streaming_conformer_gnat accumulate_steps=2 (2 '
                     'micro-steps)')
  rnn_path = 'gnat_global_bigram(use_rnn_cacher=True) train steps'
  long_path = f'B={LONG_BATCH} x {LONG_FRAMES} banded train_step'
  forward, backward = LP_COUNTERS[mode]
  by_counter = {'forward_launches': {}, 'backward_launches': {},
                forward: {}, backward: {}}
  for i, counter in enumerate(('forward_launches', 'backward_launches')):
    by_counter[counter].update({
        train_path: train_launches['steps'][i],
        accumulate_path: accumulate[i], rnn_path: rnn_launches[i]})
  by_counter[forward][long_path] = long_launches[0]
  by_counter[backward][long_path] = long_launches[1]
  by_counter['viterbi'] = {
      'streaming_conformer_gnat train() eval decode':
          train_launches['decode'],
      'gnat_global_bigram(use_rnn_cacher=True) decode': rnn_decodes}
  return by_counter


# Phase 16: time sharding. Phase 6's batch split into SEQ_BLOCKS blocks of
# frames (400 each), and once more with a block of padding only.
SEQ_BLOCKS = 4
SEQ_PADDED_T = 2000
# Kernel calls chained by their seeds against one whole call of the same
# kernels: the per-frame work is the same, only the cross-block float32
# sums of the backward's accumulators run in another order.
CHAIN_RTOLS = (F32_RTOL, 1e-4)
# Phase 16(c): the relay's decode and alignment at phase 6's lengths / 4.
SEQ_DECODE_FRAMES = [n // 4 for n in NUM_FRAMES]
SEQ_DECODE_LABELS = [n // 16 for n in SEQ_DECODE_FRAMES]
SEQ_VALUE_NAMES = ('log_z*', 'alpha*')


def chain_scans(torch, forward, backward, pf, pc, head, is_pad, g, kw,
                blocks, peaks=None):
  """A log-partition kernel pair chained over ``blocks`` equal blocks of
  frames, as the time-sharded relay runs it: the forward block by block
  from ``alpha0`` without residuals, then right to left each block's
  forward again from its saved alpha with its residuals and its backward
  from ``beta0`` with the whole sequence's log Z. ``blocks`` 1 is one
  whole call (forward with residuals, backward). ``peaks``: a list that
  gets each block's device memory peak of its recomputed forward and
  backward, above what was allocated before.

  Returns (log Z, final alpha, the backward's outputs: dpf [T, B, h]
  joined, the parameter gradients summed over the blocks, beta_out).
  """
  max_t = pf.shape[0]
  size = max_t // blocks
  part = lambda b: slice(b * size, (b + 1) * size)
  alphas, alpha = [None], None
  if blocks > 1:
    for b in range(blocks):
      _, alpha, _, _ = forward(pf[part(b)], pc, head, is_pad[part(b)],
                               with_residuals=False, alpha0=alpha, **kw)
      alphas.append(alpha)
  beta, dpfs, sums, log_z = None, [], None, None
  for b in reversed(range(blocks)):
    if peaks is not None:
      torch.cuda.synchronize()
      base = torch.cuda.memory_allocated()
      torch.cuda.reset_peak_memory_stats()
    lz, out, hist, slabs = forward(pf[part(b)], pc, head, is_pad[part(b)],
                                   with_residuals=True, alpha0=alphas[b],
                                   **kw)
    if log_z is None:
      log_z, alpha = (lz, out) if blocks == 1 else (
          torch.logsumexp(alpha, dim=-1), alpha)
    *grads, beta = backward(pf[part(b)], pc, head, is_pad[part(b)], log_z,
                            g, hist, slabs, beta0=beta, **kw)
    del hist, slabs
    if peaks is not None:
      torch.cuda.synchronize()
      peaks.append(torch.cuda.max_memory_allocated() - base)
    dpfs.insert(0, grads[0])
    sums = grads[1:] if sums is None else [a + x for a, x in
                                          zip(sums, grads[1:])]
  return log_z, alpha, [torch.cat(dpfs)] + sums + [beta]


def chain_errors(torch, got, want, rtols):
  """max_errors of two chain_scans results (values and the backward's)."""
  return max_errors(torch, list(got[:2]) + list(got[2]),
                    list(want[:2]) + list(want[2]),
                    SEQ_VALUE_NAMES + BACKWARD_NAMES, rtols)


def seq_kernel_seeds(torch, gnat, presets, fused_scan, trigram_scan):
  """Phase 16(a): the log-partition kernels chained by their relay seeds.

  gnat_global_bigram() at full width on phase 6's encoded batch (B=8,
  T_max 1600): both modes' pairs over SEQ_BLOCKS blocks of 400 frames
  against one whole call of the same kernels (CHAIN_RTOLS) and against the
  plain versions chained the same way (phase 6's long-utterance rule); then
  at T_max SEQ_PADDED_T, one more block of padding only: the chain equal to
  the four-block one, that block's alpha and beta passed through exactly
  and its gradients exactly zero. The trigram pair
  (gnat_global_bigram(vocab_size=64, context_size=2), phase 10's shape, the
  segment route) over 2 blocks, against one whole call and the plain
  versions. Prints each mode's per-block backward peak memory and the
  chained call's time against the whole call's."""
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  params = model.init(torch.Generator().manual_seed(0))
  frames, num_frames, _, _ = tp_batch(torch, config)
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  _, pf, pc, head = staged_lattice_inputs(torch, model.lattice,
                                          params['lattice'], encoded)
  max_t, batch = pf.shape[:2]
  is_pad = padding(torch, num_frames, max_t)
  g = torch.full((batch,), 1.0 / batch, device='cuda')
  kw = dict(max_expansions=config.max_expansions, frame_dependent=False,
            compute_dtype=torch.bfloat16)
  t0 = time.perf_counter()
  plain = chain_scans(torch, fused_scan.fused_forward_plain,
                      fused_scan.fused_backward_plain, pf, pc, head, is_pad,
                      g, kw, SEQ_BLOCKS)
  plain_s = time.perf_counter() - t0
  grad_rtol = max(LP_RTOL['bfloat16'][1],
                  LP_LONG_ROUNDINGS * 2.0**-24 * plain[0].abs().max().item())
  chained_cache = None
  for mode in fused_scan.MODES:
    fwd = functools.partial(fused_scan.fused_forward, mode=mode)
    bwd = functools.partial(fused_scan.fused_backward, mode=mode)
    chain_scans(torch, fwd, bwd, pf, pc, head, is_pad, g, kw,
                SEQ_BLOCKS)  # warm-up
    whole_peak, block_peaks = [], []
    whole, whole_ms = timed(torch, lambda: chain_scans(
        torch, fwd, bwd, pf, pc, head, is_pad, g, kw, 1, whole_peak))
    chained, chained_ms = timed(torch, lambda: chain_scans(
        torch, fwd, bwd, pf, pc, head, is_pad, g, kw, SEQ_BLOCKS,
        block_peaks))
    try:
      vs_whole = chain_errors(torch, chained, whole, CHAIN_RTOLS)
      vs_plain = chain_errors(torch, chained, plain,
                              (BF16_RTOL, grad_rtol))
    except SmokeFailure as e:
      raise SmokeFailure(f'{mode} chain: {e}') from None
    worst = lambda errors: max((e, n) for n, (e, _) in errors.items())
    say('seq-kernels',
        f"'{mode}' pair over {SEQ_BLOCKS} blocks of {max_t // SEQ_BLOCKS} "
        f'frames (alpha0 / beta0, the whole log Z), bf16 B={batch} '
        f'T={max_t} S={pc.shape[0]} V={config.vocab_size} h={pf.shape[2]} '
        f'FLD(2): vs one whole call at most {worst(vs_whole)[0]:.2e} '
        f'({worst(vs_whole)[1]}); vs the plain versions chained (gradient '
        f'rtol {grad_rtol:.2e}) at most {worst(vs_plain)[0]:.2e} '
        f'({worst(vs_plain)[1]}); chained {chained_ms:.1f} ms (forward '
        f'without residuals, then each block\'s forward again and its '
        f'backward) vs whole {whole_ms:.1f} ms (forward with residuals, '
        f'backward); peak memory of a block\'s recomputed forward and '
        f'backward ' + ', '.join(f'{p / 2**20:.0f}' for p in
                                 reversed(block_peaks)) +
        f' MiB vs the whole call\'s {whole_peak[0] / 2**20:.0f} MiB')
    if mode == 'cache':
      chained_cache = chained
  say('seq-kernels', f'the plain versions chained: {plain_s:.1f} s')

  # One more block of padding only (T_max SEQ_PADDED_T).
  extra = SEQ_PADDED_T - max_t
  pf_pad = torch.cat([pf, torch.randn(extra, batch, pf.shape[2],
                                      device='cuda')]).contiguous()
  is_pad_pad = padding(torch, num_frames, SEQ_PADDED_T)
  blocks = SEQ_PADDED_T // (max_t // SEQ_BLOCKS)
  fwd, bwd = fused_scan.fused_forward, fused_scan.fused_backward
  padded = chain_scans(torch, fwd, bwd, pf_pad, pc, head, is_pad_pad, g, kw,
                       blocks)
  check(not bool(padded[2][0][max_t:].any()),
        'the padding-only block has nonzero d(pf)')
  padded = (padded[0], padded[1], [padded[2][0][:max_t]] + padded[2][1:])
  pad_err = chain_errors(torch, padded, chained_cache, CHAIN_RTOLS)
  alpha = chained_cache[1]
  _, out, _, _ = fwd(pf_pad[max_t:], pc, head, is_pad_pad[max_t:],
                     with_residuals=False, alpha0=alpha, **kw)
  check(torch.equal(out, alpha), 'the padding-only block changed alpha')
  _, _, hist, slabs = fwd(pf_pad[max_t:], pc, head, is_pad_pad[max_t:],
                          with_residuals=True, alpha0=alpha, **kw)
  *grads, beta = bwd(pf_pad[max_t:], pc, head, is_pad_pad[max_t:],
                     chained_cache[0], g, hist, slabs, **kw)
  check(not bool(beta.any()), 'the padding-only block changed beta')
  check(not any(bool(x.any()) for x in grads),
        'the padding-only block has nonzero gradients')
  say('seq-kernels',
      f"'cache' pair at T_max {SEQ_PADDED_T} over {blocks} blocks, the last "
      f'padding only: vs the {SEQ_BLOCKS}-block chain at most '
      f'{max(e for e, _ in pad_err.values()):.2e}; the padding-only block '
      'passes alpha and beta through exactly, its gradients exactly 0')

  # The trigram pair over 2 blocks (the segment route).
  tri_config = presets.gnat_global_bigram(vocab_size=64, context_size=2)
  tri_model = gnat.GNATModel(tri_config, device='cuda')
  tri_params = tri_model.init(torch.Generator().manual_seed(0))
  rng = np.random.default_rng(0)
  tri_max_t = max(TRIGRAM_NUM_FRAMES)
  tri_frames = torch.from_numpy(rand(
      rng, (len(TRIGRAM_NUM_FRAMES), tri_max_t,
            tri_config.feature_size))).cuda()
  tri_nf = torch.tensor(TRIGRAM_NUM_FRAMES, device='cuda')
  with torch.no_grad():
    tri_encoded = tri_model.encoder.apply(tri_params['encoder'], tri_frames,
                                          tri_nf)
  _, tpf, tpc, thead = staged_lattice_inputs(torch, tri_model.lattice,
                                             tri_params['lattice'],
                                             tri_encoded)
  check(trigram_scan.segment_route(
      batch, tri_config.vocab_size, tpf.shape[2], torch.bfloat16,
      tri_config.max_expansions) is not None,
        'the trigram pair does not take the segment route here')
  tri_pad = padding(torch, tri_nf, tri_max_t)
  args = (tpf, tpc, thead, tri_pad, g, kw)
  tri = [chain_scans(torch, trigram_scan.trigram_forward,
                     trigram_scan.trigram_backward, *args, blocks)
         for blocks in (1, 2)]
  tri_plain = chain_scans(torch, trigram_scan.trigram_forward_plain,
                          trigram_scan.trigram_backward_plain, *args, 2)
  tri_rtol = max(LP_RTOL['bfloat16'][1], LP_LONG_ROUNDINGS * 2.0**-24 *
                 tri_plain[0].abs().max().item())
  try:
    tri_whole = chain_errors(torch, tri[1], tri[0], CHAIN_RTOLS)
    tri_vs_plain = chain_errors(torch, tri[1], tri_plain,
                                (BF16_RTOL, tri_rtol))
  except SmokeFailure as e:
    raise SmokeFailure(f'trigram chain: {e}') from None
  say('seq-kernels',
      f'trigram pair (segment route) over 2 blocks, bf16 B={batch} '
      f'T={tri_max_t} S={tpc.shape[0]} V={tri_config.vocab_size} FLD(2): '
      f'vs one whole call at most '
      f'{max(e for e, _ in tri_whole.values()):.2e}, vs the plain versions '
      f'chained at most {max(e for e, _ in tri_vs_plain.values()):.2e}')


def grads_of(pytree, params):
  """Clones of the leaves' gradients."""
  return [leaf.grad.clone() for leaf in pytree.tree_leaves(params)]


def judge_step1(torch, pytree, what, got, want, params):
  """Step 1 of a parallel step, (loss, gradients) ``got``, against ``want``:
  the loss to rtol 1e-5, each gradient within STEP_GRAD_RTOL of the
  largest. Returns the report."""
  (loss_a, grads_a), (loss_b, grads_b) = got, want
  rel = abs(loss_a - loss_b) / abs(loss_b)
  check(np.isfinite(loss_a) and rel <= 1e-5,
        f'{what}: step-1 loss {loss_a} vs {loss_b}')
  largest = max(g.abs().max().item() for g in grads_b)
  paths = [pytree.keystr(p) for p, _ in
           pytree.tree_flatten_with_path(params)[0]]
  worst, path = max(((a - b).abs().max().item() / largest, path)
                    for path, a, b in zip(paths, grads_a, grads_b))
  check(worst <= STEP_GRAD_RTOL,
        f'{what}: step-1 gradient of {path} {worst:.3g} of the largest')
  return (f'loss {loss_a:.9g} vs {loss_b:.9g} (rel {rel:.2e}), gradients '
          f'within {worst:.2e} of the largest {largest:.4g} ({path})')


def counted_steps(torch, pytree, optimizer, state, step, batch, steps,
                  module, names):
  """``steps`` counted and timed steps of a parallel ``step`` from
  ``state``: step 1 as ``loss_and_grads`` (its gradients kept before the
  clip) and the update, the others as ``step``; losses finite and falling.
  ``module``'s launch counts start from 0. Returns (step-1 (loss,
  gradients), losses, ms, launches of its counters ``names`` per step, peak
  memory, the final state)."""
  losses, step_ms, per_step = [], [], []
  reset_counts(module)
  torch.cuda.reset_peak_memory_stats()
  for i in range(steps):
    before = [getattr(module, n) for n in names]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if i == 0:
      loss = step.loss_and_grads(state, *batch)
      step1 = (loss.item(), grads_of(pytree, state.params))
      optimizer.apply_gradients(state.opt_state)
      state = dataclasses.replace(state, step=1)
    else:
      state, loss = step(state, *batch)
    end.record()
    torch.cuda.synchronize()
    step_ms.append(start.elapsed_time(end))
    losses.append(loss.item())
    per_step.append(tuple(getattr(module, n) - c
                          for n, c in zip(names, before)))
  check(all(np.isfinite(losses)) and
        all(b < a for a, b in zip(losses, losses[1:])),
        f'losses not finite and decreasing: {losses}')
  return (step1, losses, step_ms, per_step, torch.cuda.max_memory_allocated(),
          state)


def steps_report(losses, step_ms, real_frames):
  return ('losses ' + ', '.join(f'{x:.6g}' for x in losses) +
          '; step ms ' + ', '.join(f'{x:.1f}' for x in step_ms) + ' (' +
          ', '.join(f'{real_frames / x * 1e3:.0f}' for x in step_ms) +
          ' real frames/s)')


def seq_steps(torch, gnat, presets, fused_scan, sharded_scan, sharding,
              sequence, pytree):
  """Phase 16(b): the time-sharded steps on the one-process NCCL group.

  ``make_time_sharded_train_step(fused='auto')`` on a ('seq',) mesh of 1
  takes TRAIN_STEPS counted and timed steps on phase 6's batch (the kernel
  relay: 2 forwards and 1 backward a step, the block's forward recomputed),
  losses falling; step 1's loss and gradients (before the clip) against
  ``gnat.train_step``'s, the single-device bigram kernels: loss rtol 1e-5,
  gradients within STEP_GRAD_RTOL of the largest. ``make_tp_seq_train_step``
  on a 1 x 1 ('seq', 'model') mesh takes 2 steps, losses falling, step 1
  against ``make_tp_train_step``'s the same way (frame_reduce: per frame 2
  forwards, 2 more recomputed and 2 backwards under FLD(2)). Returns
  {counter: {path: launches}} of the two modules' kernels."""
  from torch.distributed.device_mesh import init_device_mesh
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  batch = tp_batch(torch, config)
  max_t = batch[0].shape[1]
  real_frames = sum(NUM_FRAMES)

  def state0():
    return gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                 optimizer)

  def judge(what, got, want, params):
    return judge_step1(torch, pytree, what, got, want, params)

  def run(step, steps, module, names):
    *out, state = counted_steps(torch, pytree, optimizer, state0(), step,
                                batch, steps, module, names)
    return (*out, state.params)

  def report(losses, step_ms):
    return steps_report(losses, step_ms, real_frames)

  # The time-sharded step against gnat.train_step's step 1.
  t0 = time.perf_counter()
  single = state0()
  want = loss_and_grads(torch, pytree.tree_leaves(single.params),
                        lambda: model.mean_loss(single.params, *batch))
  del single
  seq_mesh = init_device_mesh('cuda', (1,), mesh_dim_names=('seq',))
  step = sequence.make_time_sharded_train_step(model, optimizer, seq_mesh,
                                               fused='auto')
  names = LP_COUNTERS['cache']
  step1, losses, step_ms, per_step, peak, params = run(
      step, TRAIN_STEPS, fused_scan, names)
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  checked = judge('time-sharded', step1, want, params)
  check(all(n == (2, 1) for n in per_step),
        f"'cache' launches per time-sharded step {per_step}, not (2, 1)")
  check(not fused_scan.online_forward_launches,
        'the time-sharded steps launched the online kernels')
  path = f'gnat_global_bigram time-sharded steps ({TRAIN_STEPS})'
  launches = {name: {path: getattr(fused_scan, name)} for name in names}
  say('seq-steps',
      f"make_time_sharded_train_step(fused='auto') on a ('seq',) mesh of "
      f'1, gnat_global_bigram B={len(NUM_FRAMES)} T_max={max_t}: step 1 vs '
      f'gnat.train_step: {checked}; {TRAIN_STEPS} steps: '
      f"{report(losses, step_ms)}; 'cache' launches per step (forward, "
      f'backward) {per_step}; peak memory {peak / 2**30:.2f} GiB '
      f'({time.perf_counter() - t0:.1f} s)')

  # The seq x tp step against make_tp_train_step's step 1.
  t0 = time.perf_counter()
  tp_mesh = sharding.make_mesh(model_parallel=1)
  tp_step, shard_state = sharding.make_tp_train_step(model, optimizer,
                                                     tp_mesh)
  reference = shard_state(state0())
  want = (tp_step.loss_and_grads(reference, *batch).item(),
          grads_of(pytree, reference.params))
  del reference
  sxm_mesh = init_device_mesh('cuda', (1, 1),
                              mesh_dim_names=('seq', 'model'))
  step = sequence.make_tp_seq_train_step(model, optimizer, sxm_mesh)
  names = ('forward_launches', 'backward_launches')
  reset_counts(fused_scan)
  step1, losses, step_ms, per_step, peak, params = run(step, 2, sharded_scan,
                                                       names)
  checked = judge('seq x tp', step1, want, params)
  check(all(n == (4 * max_t, 2 * max_t) for n in per_step),
        f'frame_reduce launches per seq x tp step {per_step}, not '
        f'({4 * max_t}, {2 * max_t})')
  check(not any(counts(fused_scan).values()),
        'the seq x tp steps launched bigram kernels')
  path = 'gnat_global_bigram seq x tp steps (2)'
  launches.update({f'frame_reduce {name}': {path: getattr(sharded_scan, name)}
                   for name in names})
  say('seq-steps',
      f"make_tp_seq_train_step on a ('seq', 'model') mesh of 1 x 1: step 1 "
      f'vs make_tp_train_step: {checked}; 2 steps: {report(losses, step_ms)}'
      f'; frame_reduce launches per step (forward, backward) {per_step}; '
      f'peak memory {peak / 2**30:.2f} GiB '
      f'({time.perf_counter() - t0:.1f} s)')
  return launches


def seq_decode_align(torch, gnat, presets, sequence, joint_head, pytree):
  """Phase 16(c): decode and align through the relay on a ('seq',) mesh of
  1, gnat_global_bigram() at full width on phase 6's lengths / 4, against
  the single-device generic decode (``fused='never'``: the same function,
  float32) and ``align``, by the decode rules at float32 (ROADMAP §3):
  path weights and scores to F32_RTOL, rows whose labels differ must tie
  (the relay's alignment rescored in float64 scores the single-device
  path's weight). Returns the relay decode's joint+head forward launches."""
  from torch.distributed.device_mesh import init_device_mesh
  mesh = init_device_mesh('cuda', (1,), mesh_dim_names=('seq',))
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  params = model.init(torch.Generator().manual_seed(0))
  lattice, lattice_params = model.lattice, params['lattice']
  rng = np.random.default_rng(0)
  max_t = max(SEQ_DECODE_FRAMES)
  frames = torch.from_numpy(rand(
      rng, (len(SEQ_DECODE_FRAMES), max_t, config.feature_size))).cuda()
  labels = torch.from_numpy(rng.integers(
      1, config.vocab_size + 1,
      size=(len(SEQ_DECODE_FRAMES), max(SEQ_DECODE_LABELS)))).cuda()
  num_frames = torch.tensor(SEQ_DECODE_FRAMES, device='cuda')
  num_labels = torch.tensor(SEQ_DECODE_LABELS, device='cuda')
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  t0 = time.perf_counter()
  reset_counts(joint_head)
  relay, relay_ms = timed(torch, lambda: sequence.shortest_path_time_sharded(
      lattice, lattice_params, encoded, num_frames, mesh, 'seq'))
  launches = joint_head.forward_launches
  check(launches >= max_t, f'the relay decode launched the joint+head '
        f'forward {launches} times, not at least once a frame')
  lattice.fused = 'never'
  try:
    single, single_ms = timed(torch, lambda: lattice.shortest_path(
        lattice_params, encoded, num_frames))
  finally:
    lattice.fused = 'auto'
  _, pf, pc, _ = staged_lattice_inputs(torch, lattice, lattice_params,
                                       encoded)
  rescored = rescore(torch, relay[0], num_frames, pf, pc,
                     lattice_params['weight_fn'],
                     max_expansions=config.max_expansions,
                     frame_dependent=False, compute_dtype=torch.float32)
  decode = compare_decodes(torch, relay, single, rescored, torch.float32)
  emit_r, score_r = sequence.align_time_sharded(
      lattice, lattice_params, encoded, num_frames, labels, num_labels, mesh,
      'seq')
  (emit_s, score_s), align_ms = timed(torch, lambda: lattice.align(
      lattice_params, encoded, num_frames, labels, num_labels))
  rel = relative(torch, score_r, score_s)
  check(bool(torch.isfinite(score_r).all()) and
        bool((rel <= F32_RTOL).all()),
        f'relay align scores differ by {rel.max().item():.3g} relative')
  differ = [b for b in range(len(SEQ_DECODE_FRAMES))
            if not torch.equal(emit_r[b], emit_s[b])]
  say('seq-decode',
      f'gnat_global_bigram B={len(SEQ_DECODE_FRAMES)} T_max={max_t}, the '
      "relay on a ('seq',) mesh of 1: decode "
      f'{relay_ms:.1f} ms vs the '
      f'single-device generic route {single_ms:.1f} ms ({decode}); '
      f'joint+head forward launches {launches}; align vs align '
      f'({align_ms:.1f} ms): scores max rel {rel.max().item():.2e}, emit '
      f'frames ' + ('equal' if not differ else
                    f'differ on tied rows {differ}') +
      f' ({time.perf_counter() - t0:.1f} s)')
  return launches


def phase_time_sharding(torch, gnat, presets, fused_scan, trigram_scan,
                        sharded_scan, joint_head, sharding, sequence,
                        pytree):
  """Phase 16: time sharding on the card. (a) ``seq_kernel_seeds``; then,
  on a one-process NCCL group (NCCL takes no two ranks on one GPU, so the
  relay runs with a time axis of 1 here and its D > 1 chaining of the
  kernels in (a)), (b) ``seq_steps`` and (c) ``seq_decode_align``. Returns
  the launches of (b) and (c) by counter and path."""
  import torch.distributed as dist
  t0 = time.perf_counter()
  seq_kernel_seeds(torch, gnat, presets, fused_scan, trigram_scan)
  say('seq-kernels', f'{time.perf_counter() - t0:.1f} s')
  dist.init_process_group('nccl', store=dist.HashStore(), rank=0,
                          world_size=1)
  try:
    torch.cuda.empty_cache()
    launches = seq_steps(torch, gnat, presets, fused_scan, sharded_scan,
                         sharding, sequence, pytree)
    torch.cuda.empty_cache()
    decode_launches = seq_decode_align(torch, gnat, presets, sequence,
                                       joint_head, pytree)
  finally:
    dist.destroy_process_group()
  launches['joint_head forward_launches'] = {
      f'gnat_global_bigram time-sharded decode (T={max(SEQ_DECODE_FRAMES)})':
          decode_launches}
  return launches


PP_MICROBATCHES = (2, 4)
# Steps of the pipelined step at each M: TRAIN_STEPS at M=2; step 1 alone
# at M=4.
PP_STEPS = (TRAIN_STEPS, 1)


def float64_lattice_grads(torch, pytree, sharded_scan, model, params,
                          batch):
  """{leaf path: float64 gradient} of the lattice leaves of the whole
  batch's mean loss on its float32 encoder outputs, through the plain
  versions in float64 (phase 12's float64 route: the same bfloat16
  roundings of the joint and head, float64 sums)."""
  with torch.no_grad():
    encoded = model.encoder.apply(params['encoder'], *batch[:2])
  _, grads = lattice_step1(
      torch, pytree, params['lattice'], encoded, torch.float64,
      lambda p, e: sharded_scan.tp_lattice_loss(
          model.lattice, p, e, *batch[1:],
          reduce=float64_frame_reduce(torch, sharded_scan)))
  return {"['lattice']" + name: grad for name, grad in grads.items()
          if name != 'encoded'}


def judge_vs_whole_batch(torch, pytree, what, got, want, ref, params):
  """Step 1 of a pipelined step, (loss, gradients) ``got``, against the
  whole batch's ``gnat.train_step`` step 1 ``want``, whose float32 lattice
  gradients the float64 reference ``ref`` (``float64_lattice_grads``)
  reads: the loss to rtol 1e-5; each lattice leaf's gradient within
  max(STEP_GRAD_RTOL, twice the whole-batch step's error) of the float64
  one, and within max(STEP_GRAD_RTOL, the whole-batch step's error) of the
  whole-batch step's; each encoder leaf's within STEP_GRAD_RTOL of the
  whole-batch step's; all relative to the largest whole-batch gradient.
  Returns the report."""
  (loss_a, grads_a), (loss_b, grads_b) = got, want
  rel = abs(loss_a - loss_b) / abs(loss_b)
  check(np.isfinite(loss_a) and rel <= 1e-5,
        f'{what}: step-1 loss {loss_a} vs {loss_b}')
  largest = max(g.abs().max().item() for g in grads_b)
  paths = [pytree.keystr(p) for p, _ in
           pytree.tree_flatten_with_path(params)[0]]
  gaps, errors = {}, {}
  for path, a, b in zip(paths, grads_a, grads_b):
    check(bool(torch.isfinite(a).all()), f'{what}: {path} not finite')
    gaps[path] = (a - b).abs().max().item() / largest
    limit = STEP_GRAD_RTOL
    if path in ref:
      err_a, err_b = ((x.double() - ref[path]).abs().max().item() / largest
                      for x in (a, b))
      errors[path] = (err_a, err_b)
      check(err_a <= max(STEP_GRAD_RTOL, 2 * err_b),
            f'{what}: step-1 gradient of {path} {err_a:.3g} of the largest '
            f'from float64, the whole-batch step {err_b:.3g}')
      limit = max(STEP_GRAD_RTOL, err_b)
    check(gaps[path] <= limit,
          f'{what}: step-1 gradient of {path} {gaps[path]:.3g} of the '
          f'largest from the whole-batch step (limit {limit:.3g})')
  worst = max((gap, path) for path, gap in gaps.items())
  encoder = max((gap, path) for path, gap in gaps.items()
                if path not in ref)
  return (f'loss {loss_a:.9g} vs {loss_b:.9g} (rel {rel:.2e}); gradients '
          f'vs the whole-batch step, of the largest {largest:.4g}: at most '
          f'{worst[0]:.2e} ({worst[1]}), encoder leaves at most '
          f'{encoder[0]:.2e} ({encoder[1]}); lattice leaves vs float64 '
          '(pipelined, whole batch): ' + ', '.join(
              f'{path} ({a:.2e}, {b:.2e})'
              for path, (a, b) in errors.items()))


def pp_steps(torch, gnat, presets, fused_scan, sharded_scan, pipeline,
             pytree):
  """Phase 17(a)-(c) on the one-process NCCL group, gnat_global_bigram()
  at full width on phase 6's batch. (a) ``make_pp_train_step`` on a
  ('data', 'pipe') 1 x 1 mesh at M = 2 (PP_STEPS: 3 steps, losses
  falling) and 4 (step 1), step 1 against the whole batch's
  ``gnat.train_step`` by ``judge_vs_whole_batch``: FLD's ``blank_b``
  gradient is float32 residue (its float64 value is near 0), which the
  microbatches' shapes move by ~1e-3 of the largest gradient, so its
  limit comes from the whole-batch step's own distance from the float64
  plain versions (``float64_lattice_grads``); 'cache' launches a step 2M
  forwards (the last stage's forward, then its recompute in the backward)
  and M backwards. (b) ``make_pp_encode_fn`` (M = 2) against
  ``encoder.apply`` over the same microbatches (rtol 1e-5 / atol 1e-6) and
  on the whole batch (within 1e-5 of the encoding's largest entry: cuBLAS
  runs other float32 kernels for 4 rows than for 8). (c)
  ``make_pp_seq_train_step`` on ('pipe', 'seq') 1 x 1 with
  ``fused='auto'`` (the kernel relay): 2 steps, step 1 as (a)'s. Returns
  (the whole-batch step 1, {counter: {path: launches}})."""
  from torch.distributed.device_mesh import init_device_mesh
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  optimizer = gnat.make_optimizer(LEARNING_RATE)
  batch = tp_batch(torch, config)
  max_t = batch[0].shape[1]
  real_frames = sum(NUM_FRAMES)
  names = LP_COUNTERS['cache']

  def state0():
    return gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                 optimizer)

  t0 = time.perf_counter()
  single = state0()
  want = loss_and_grads(torch, pytree.tree_leaves(single.params),
                        lambda: model.mean_loss(single.params, *batch))
  params = single.params
  ref = float64_lattice_grads(torch, pytree, sharded_scan, model, params,
                              batch)
  say('pipeline', f'the whole-batch gnat.train_step step 1 and its float64 '
      f'lattice reference ({time.perf_counter() - t0:.1f} s)')
  launches = {name: {} for name in names}
  mesh = init_device_mesh('cuda', (1, 1), mesh_dim_names=('data', 'pipe'))
  for m, steps in zip(PP_MICROBATCHES, PP_STEPS):
    t0 = time.perf_counter()
    step = pipeline.make_pp_train_step(model, optimizer, mesh, m,
                                       data_axis='data')
    step1, losses, step_ms, per_step, peak, _ = counted_steps(
        torch, pytree, optimizer, state0(), step, batch, steps, fused_scan,
        names)
    check(model.lattice.last_path == 'kernel',
          f'last_path is {model.lattice.last_path!r}, not kernel')
    checked = judge_vs_whole_batch(torch, pytree, f'pipeline M={m}', step1,
                                   want, ref, params)
    check(all(n == (2 * m, m) for n in per_step),
          f"'cache' launches per pipelined step {per_step}, not "
          f'({2 * m}, {m})')
    path = f'gnat_global_bigram pipelined steps (M={m}, {steps})'
    for name in names:
      launches[name][path] = getattr(fused_scan, name)
    say('pipeline',
        f"make_pp_train_step on a ('data', 'pipe') mesh of 1 x 1, M={m}, "
        f'gnat_global_bigram B={len(NUM_FRAMES)} T_max={max_t}: step 1 vs '
        f'gnat.train_step: {checked}; {steps} steps: '
        f"{steps_report(losses, step_ms, real_frames)}; 'cache' launches "
        f'per step (forward, backward) {per_step}; peak memory '
        f'{peak / 2**30:.2f} GiB ({time.perf_counter() - t0:.1f} s)')

  t0 = time.perf_counter()
  encode = pipeline.make_pp_encode_fn(model, mesh, 2, data_axis='data')
  size = len(NUM_FRAMES) // 2
  with torch.no_grad():
    got, pp_ms = timed(torch, lambda: encode(params['encoder'], *batch[:2]))
    ref_rows = torch.cat([model.encoder.apply(
        params['encoder'], *(x[j * size:(j + 1) * size] for x in batch[:2]))
                          for j in range(2)])
    whole, plain_ms = timed(torch, lambda: model.encoder.apply(
        params['encoder'], *batch[:2]))
  err = (got - ref_rows).abs().max().item()
  check(bool(torch.allclose(got, ref_rows, rtol=1e-5, atol=1e-6)),
        f'the pipelined encoding differs from encoder.apply over the same '
        f'microbatches by {err:.3g}')
  scale = whole.abs().max().item()
  err_whole = (got - whole).abs().max().item()
  check(err_whole <= 1e-5 * scale,
        f'the pipelined encoding differs from encoder.apply on the whole '
        f'batch by {err_whole:.3g}, scale {scale:.4g}')
  say('pipeline', f'make_pp_encode_fn (M=2) vs encoder.apply: over the same '
      f'microbatches max |a-b| {err:.2e}, on the whole batch '
      f'{err_whole:.2e}, of scale {scale:.4g}; {pp_ms:.1f} ms vs '
      f'{plain_ms:.1f} ms ({time.perf_counter() - t0:.1f} s)')

  t0 = time.perf_counter()
  seq_mesh = init_device_mesh('cuda', (1, 1), mesh_dim_names=('pipe', 'seq'))
  step = pipeline.make_pp_seq_train_step(model, optimizer, seq_mesh, 2,
                                         fused='auto')
  step1, losses, step_ms, per_step, peak, _ = counted_steps(
      torch, pytree, optimizer, state0(), step, batch, 2, fused_scan, names)
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  checked = judge_vs_whole_batch(torch, pytree, 'pp x seq', step1, want, ref,
                                 params)
  check(all(n == (2, 1) for n in per_step),
        f"'cache' launches per pp x seq step {per_step}, not (2, 1)")
  path = 'gnat_global_bigram pp x seq steps (M=2, 2)'
  for name in names:
    launches[name][path] = getattr(fused_scan, name)
  say('pipeline',
      f"make_pp_seq_train_step(fused='auto') on a ('pipe', 'seq') mesh of "
      f'1 x 1, M=2: step 1 vs gnat.train_step: {checked}; 2 steps: '
      f"{steps_report(losses, step_ms, real_frames)}; 'cache' launches per "
      f'step (forward, backward) {per_step}; peak memory '
      f'{peak / 2**30:.2f} GiB ({time.perf_counter() - t0:.1f} s)')
  return want, launches


def sharded_steps(torch, gnat, presets, fused_scan, joint_head, sharding,
                  pytree, want):
  """Phase 17(d): ``make_sharded_train_step`` on a ('data', 'model') 1 x 1
  mesh, the Megatron encoder (its sums an NCCL all-reduce of one rank) and
  the lattice on the gathered head: gnat_global_bigram() by its own route
  (the 'cache' pair, one each way a step), 2 steps, step 1 against
  ``gnat.train_step``'s (``want``); then the path ``train(model_parallel >
  1)`` takes where no tensor-parallel plan does, the trigram
  gnat_global_bigram(vocab_size=64, context_size=2) at phase 10's shape
  with ``fused='never'``: the generic route, its 4161-state applies through
  the joint+head kernels, 2 steps, step 1 against ``gnat.train_step`` on
  the same route. Returns {counter: {path: launches}}."""
  mesh = sharding.make_mesh(model_parallel=1)
  launches = {}

  def run(config, batch, want, module, names, what, fused='auto'):
    model = gnat.GNATModel(config, device='cuda')
    model.lattice.fused = fused
    optimizer = gnat.make_optimizer(LEARNING_RATE)
    full = gnat.init_train_state(model, torch.Generator().manual_seed(0),
                                 optimizer)
    if want is None:
      reset_counts(module)
      want = loss_and_grads(torch, pytree.tree_leaves(full.params),
                            lambda: model.mean_loss(full.params, *batch))
      reference = tuple(getattr(module, n) for n in names)
      for leaf in pytree.tree_leaves(full.params):
        leaf.grad = None
    else:
      reference = None
    step, shard_state = sharding.make_sharded_train_step(model, optimizer,
                                                         mesh)
    step1, losses, step_ms, per_step, peak, _ = counted_steps(
        torch, pytree, optimizer, shard_state(full), step, batch, 2, module,
        names)
    checked = judge_step1(torch, pytree, what, step1, want, full.params)
    return model, checked, losses, step_ms, per_step, peak, reference

  t0 = time.perf_counter()
  config = presets.gnat_global_bigram()
  batch = tp_batch(torch, config)
  names = LP_COUNTERS['cache']
  model, checked, losses, step_ms, per_step, peak, _ = run(
      config, batch, want, fused_scan, names, 'sharded')
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  check(all(n == (1, 1) for n in per_step),
        f"'cache' launches per sharded step {per_step}, not (1, 1)")
  path = 'gnat_global_bigram sharded steps (Megatron encoder, 2)'
  launches.update({name: {path: getattr(fused_scan, name)}
                   for name in names})
  say('sharded',
      f"make_sharded_train_step on a ('data', 'model') mesh of 1 x 1, "
      f'gnat_global_bigram B={len(NUM_FRAMES)} T_max={max(NUM_FRAMES)}: '
      f'step 1 vs gnat.train_step: {checked}; 2 steps: '
      f'{steps_report(losses, step_ms, sum(NUM_FRAMES))}; \'cache\' '
      f'launches per step (forward, backward) {per_step}; peak memory '
      f'{peak / 2**30:.2f} GiB ({time.perf_counter() - t0:.1f} s)')

  t0 = time.perf_counter()
  config = presets.gnat_global_bigram(vocab_size=64, context_size=2)
  rng = np.random.default_rng(0)
  max_t = max(TRIGRAM_NUM_FRAMES)
  batch = (torch.from_numpy(rand(rng, (len(TRIGRAM_NUM_FRAMES), max_t,
                                       config.feature_size))).cuda(),
           torch.tensor(TRIGRAM_NUM_FRAMES, device='cuda'),
           torch.from_numpy(rng.integers(
               1, config.vocab_size + 1,
               size=(len(TRIGRAM_NUM_FRAMES),
                     max(TRIGRAM_NUM_LABELS)))).cuda(),
           torch.tensor(TRIGRAM_NUM_LABELS, device='cuda'))
  names = ('forward_launches', 'backward_launches')
  reset_counts(fused_scan)
  model, checked, losses, step_ms, per_step, peak, reference = run(
      config, batch, None, joint_head, names, 'sharded fallback',
      fused='never')
  check(model.lattice.last_path == 'generic',
        f'last_path is {model.lattice.last_path!r}, not generic')
  check(all(n == reference and n[1] >= max_t for n in per_step),
        f'joint+head launches per sharded fallback step {per_step}, not '
        f'the single-device step\'s {reference}')
  check(not any(counts(fused_scan).values()),
        'the sharded fallback launched log-partition kernels')
  path = 'gnat_global_bigram(vocab_size=64, context_size=2) sharded ' \
         'fallback steps (2)'
  launches.update({f'joint_head {name}': {path: getattr(joint_head, name)}
                   for name in names})
  say('sharded',
      "the fallback of train(model_parallel > 1): fused='never' and "
      f'make_sharded_train_step, gnat_global_bigram(vocab_size=64, '
      f'context_size=2) B={len(TRIGRAM_NUM_FRAMES)} T_max={max_t}: step 1 '
      f"vs gnat.train_step (fused='never'): {checked}; 2 steps: "
      f'{steps_report(losses, step_ms, sum(TRIGRAM_NUM_FRAMES))}; '
      f'joint+head launches per step (forward, backward) {per_step}, the '
      f'single-device step {reference}; peak memory {peak / 2**30:.2f} GiB '
      f'({time.perf_counter() - t0:.1f} s)')
  return launches


def phase_model_parallel(torch, gnat, presets, fused_scan, joint_head,
                         sharded_scan, sharding, pipeline, pytree):
  """Phase 17: pipeline (GPipe) and Megatron-sharded training on a
  one-process NCCL group (NCCL takes no two ranks on one GPU, so each axis
  has one rank here; ``tools/tp_multicard.py`` runs them across cards):
  ``pp_steps`` and ``sharded_steps``. Returns the launches of both by
  counter and path."""
  import torch.distributed as dist
  dist.init_process_group('nccl', store=dist.HashStore(), rank=0,
                          world_size=1)
  try:
    torch.cuda.empty_cache()
    want, launches = pp_steps(torch, gnat, presets, fused_scan,
                              sharded_scan, pipeline, pytree)
    torch.cuda.empty_cache()
    for counter, paths in sharded_steps(torch, gnat, presets, fused_scan,
                                        joint_head, sharding, pytree,
                                        want).items():
      launches.setdefault(counter, {}).update(paths)
  finally:
    dist.destroy_process_group()
  return launches


def main():
  import torch
  if not torch.cuda.is_available():
    raise SmokeFailure('no CUDA device: torch.cuda.is_available() is False')
  try:
    from torch.utils import _pytree as pytree

    from last_torch_tpu_torch import (alignments, contexts, lattices, risk,
                                      semirings, streaming, weight_fns)
    from last_torch_tpu_torch import data as data_lib
    from last_torch_tpu_torch.models import encoder as encoder_lib
    from last_torch_tpu_torch.models import gnat, presets
    from last_torch_tpu_torch.models import train as train_lib
    from last_torch_tpu_torch.utils import checkpoint as checkpoint_lib
    from last_torch_tpu_torch.ops import (build, fused_scan, joint_head,
                                          numerator_scan, sharded_scan,
                                          trigram_scan, viterbi)
    from last_torch_tpu_torch.parallel import pipeline, sequence, sharding
  except ImportError as e:
    raise SmokeFailure(f'run from the root of a checkout ({e})') from None

  start = time.perf_counter()
  # Phase 1: device.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  print(card_line(), flush=True)  # name, power.limit as nvidia-smi gives
  CARD['sms'], CARD['clock_mhz'] = card_clock()
  print(f'[device] torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}, '
        f'{CARD["sms"]} SMs, max SM clock {CARD["clock_mhz"]} MHz, TF32 off',
        flush=True)

  # Phase 2: build from the checkout's sources.
  t0 = time.perf_counter()
  for line in phase_build(build, {'viterbi.cu': viterbi,
                                  'fused_scan.cu': fused_scan,
                                  'numerator_scan.cu': numerator_scan,
                                  'joint_head.cu': joint_head,
                                  'sharded_scan.cu': sharded_scan}):
    print(f'[build] {line}', flush=True)
  print(f'[build] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 3: Viterbi kernel against plain.
  t0 = time.perf_counter()
  for line in phase_kernel_vs_plain(torch, viterbi):
    print(f'[kernel-vs-plain] {line}', flush=True)
  print(f'[kernel-vs-plain] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 3c: the joint+head kernels against plain.
  t0 = time.perf_counter()
  for line in phase_joint_head_vs_plain(torch, joint_head):
    print(f'[jh-kernel-vs-plain] {line}', flush=True)
  print(f'[jh-kernel-vs-plain] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 4: the serving main path, gnat_global_bigram at full width.
  t0 = time.perf_counter()
  config = presets.gnat_global_bigram()
  model = gnat.GNATModel(config, device='cuda')
  params = model.init(torch.Generator().manual_seed(0))
  rng = np.random.default_rng(0)
  frames = torch.from_numpy(
      rand(rng, (len(NUM_FRAMES), max(NUM_FRAMES), config.feature_size))
  ).cuda()
  num_frames = torch.tensor(NUM_FRAMES, device='cuda')
  decode = lambda: model.decode(params, frames, num_frames)
  torch.cuda.synchronize()
  decode()  # warm-up
  torch.cuda.synchronize()
  viterbi.launches = 0
  (labels, num_labels, weights), decode_ms = timed(torch, decode)
  launches = viterbi.launches
  check(launches >= 1, 'the decode did not launch the Viterbi kernel')
  check(model.lattice.last_path == 'kernel',
        f'last_path is {model.lattice.last_path!r}, not kernel')
  num_align = config.max_expansions + 1
  check(torch.equal(num_labels, num_align * num_frames.int()),
        'num_alignment_labels != 3 * num_frames')
  check(int(labels.min()) >= 0 and int(labels.max()) <= config.vocab_size,
        'labels outside [0, V]')
  slot = torch.arange(labels.shape[1], device='cuda')[None]
  check(not bool(labels[slot >= num_labels[:, None]].any()),
        'padding slots are not blank')
  check(bool(torch.isfinite(weights).all()), 'path weights not finite')

  lattice_params = params['lattice']
  wf_params = lattice_params['weight_fn']
  bigram = dict(max_expansions=config.max_expansions, frame_dependent=False)

  def plain_decode():
    encoded = model.encoder.apply(params['encoder'], frames, num_frames)
    cache = model.lattice.build_cache(lattice_params)
    return viterbi.viterbi_decode(
        wf_params, cache, encoded, num_frames, **bigram,
        compute_dtype=torch.bfloat16, forward=viterbi.viterbi_forward_plain)

  plain_decode()  # warm-up
  plain_out, plain_decode_ms = timed(torch, plain_decode)
  encoded = model.encoder.apply(params['encoder'], frames, num_frames)
  cache = model.lattice.build_cache(lattice_params)
  pf = torch.einsum('btf,fh->tbh', encoded, wf_params['frame_proj'])
  pc = cache @ wf_params['context_proj']
  rescored = rescore(torch, labels, num_frames, pf, pc, wf_params, **bigram,
                     compute_dtype=torch.bfloat16)
  report = compare_decodes(torch, (labels, num_labels, weights), plain_out,
                           rescored, torch.bfloat16)
  real_frames = sum(NUM_FRAMES)
  print(f'[main-path] gnat_global_bigram B={len(NUM_FRAMES)} '
        f'T_max={max(NUM_FRAMES)}: kernel decode {decode_ms:.1f} ms '
        f'({real_frames / decode_ms * 1e3:.0f} frames/s), plain decode '
        f'{plain_decode_ms:.1f} ms ({real_frames / plain_decode_ms * 1e3:.0f}'
        f' frames/s), launches {launches}; vs plain: {report}', flush=True)

  # The kernel alone against its plain version at the main path's shapes
  # (these launches are outside the counted run).
  pf, pc = pf.contiguous(), pc.contiguous()
  is_pad = (torch.arange(frames.shape[1], device='cuda')[:, None] >=
            num_frames[None, :])
  fwd = dict(**bigram, compute_dtype=torch.bfloat16)
  viterbi.viterbi_forward(pf, pc, wf_params, is_pad, **fwd)  # warm-up
  (_, _, alpha_k), kernel_ms = timed(
      torch, lambda: viterbi.viterbi_forward(pf, pc, wf_params, is_pad,
                                             **fwd), repeats=3)
  (_, _, alpha_p), plain_ms = timed(
      torch, lambda: viterbi.viterbi_forward_plain(pf, pc, wf_params, is_pad,
                                                   **fwd), repeats=3)
  encode = lambda: model.encoder.apply(params['encoder'], frames, num_frames)
  _, encoder_ms = timed(torch, encode, repeats=3)
  forward_out = viterbi.viterbi_forward(pf, pc, wf_params, is_pad, **fwd)
  _, backtrace_ms = timed(
      torch, lambda: viterbi.backtrace(*forward_out, is_pad, **bigram),
      repeats=3)
  finite = torch.isfinite(alpha_p)
  check(torch.equal(finite, torch.isfinite(alpha_k)),
        'final alpha: kernel and plain differ in which states are reachable')
  max_abs_err = (alpha_k[finite] - alpha_p[finite]).abs().max().item()
  scale = alpha_p[finite].abs().max().item()
  check(max_abs_err <= BF16_RTOL * scale,
        f'final alpha differs by {max_abs_err} (scale {scale})')
  print(f'[kernel-alone] viterbi_forward bf16 B=8 T=1600 S=1025 V=1024 '
        f'h=512: kernel {kernel_ms:.1f} ms, plain {plain_ms:.1f} ms; final '
        f'alpha max abs err {max_abs_err:.3g} of scale {scale:.4g}; encoder '
        f'{encoder_ms:.1f} ms, backtrace {backtrace_ms:.1f} ms', flush=True)
  print(f'[main-path] {decode_split(decode_ms, kernel_ms, backtrace_ms)}',
        flush=True)
  print(f'[main-path] serving phases {time.perf_counter() - t0:.1f} s',
        flush=True)
  # One head product per real frame-row: FLD(2)'s second pass reads the
  # staged lex.
  flops = 2.0 * real_frames * pc.shape[0] * wf_params['vocab_w'].numel()
  traffic = (nbytes(pf, pc, is_pad, *(wf_params[n] for n in (
      'vocab_w', 'vocab_b', 'blank_w', 'blank_b'))) + nbytes(*forward_out))
  del model, params, frames, encoded, cache, pf, pc, forward_out

  # Phase 4b: the HAT serving main path.
  t0 = time.perf_counter()
  hat_launches, hat_ms, hat_plain_ms, hat_err = phase_hat_serving(
      torch, gnat, presets, viterbi)
  print(f'[hat-serving] {time.perf_counter() - t0:.1f} s', flush=True)
  # The bfloat16 forward's products live in csrc/head_product.cuh (its
  # host loop and merges in csrc/viterbi.cu).
  viterbi_record = kernel_record(
      'viterbi_forward', 'head_product.cuh', 'viterbi.py:46',
      launches + hat_launches, max(max_abs_err, hat_err), kernel_ms,
      plain_ms, flops, traffic, 'bfloat16',
      launches_by_path={'gnat_global_bigram decode': launches,
                        'hat_bigram decode': hat_launches},
      hat_ms=hat_ms, hat_plain_ms=hat_plain_ms)

  # Phase 5: log-partition kernels against plain.
  t0 = time.perf_counter()
  for line in phase_log_partition_vs_plain(torch, fused_scan):
    print(f'[lp-kernel-vs-plain] {line}', flush=True)
  print(f'[lp-kernel-vs-plain] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 5b: numerator kernels against plain.
  t0 = time.perf_counter()
  for line in phase_numerator_vs_plain(torch, numerator_scan):
    print(f'[num-kernel-vs-plain] {line}', flush=True)
  print(f'[num-kernel-vs-plain] {time.perf_counter() - t0:.1f} s',
        flush=True)

  # Phase 5c: the marginals kernel against plain.
  t0 = time.perf_counter()
  for line in phase_marginals_vs_plain(torch, fused_scan):
    print(f'[marg-kernel-vs-plain] {line}', flush=True)
  print(f'[marg-kernel-vs-plain] {time.perf_counter() - t0:.1f} s',
        flush=True)

  # Phase 5d: the online kernels against plain and against the cache ones.
  t0 = time.perf_counter()
  for line in phase_online_vs_plain(torch, fused_scan):
    print(f'[online-kernel-vs-plain] {line}', flush=True)
  print(f'[online-kernel-vs-plain] {time.perf_counter() - t0:.1f} s',
        flush=True)

  # Phase 5e: the trigram kernels against plain.
  t0 = time.perf_counter()
  for line in phase_trigram_vs_plain(torch, contexts, trigram_scan):
    print(f'[trigram-kernel-vs-plain] {line}', flush=True)
  print(f'[trigram-kernel-vs-plain] {time.perf_counter() - t0:.1f} s',
        flush=True)

  # Phase 6: the training main path.
  t0 = time.perf_counter()
  records = phase_training(torch, gnat, presets, fused_scan, semirings,
                           pytree)
  print(f'[train] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 6b: the HAT training main path.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  numerator_records = phase_hat_training(torch, gnat, presets, numerator_scan,
                                         semirings, pytree)
  print(f'[hat-train] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 7: the kernels at the headline loss configuration.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  phase_headline(torch, lattices, contexts, alignments, weight_fns, gnat,
                 presets, fused_scan, semirings, pytree)
  print(f'[headline] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 7b: the numerator kernels at bench config 7.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  phase_hat_headline(torch, lattices, contexts, alignments, weight_fns,
                     numerator_scan, semirings, pytree)
  print(f'[hat-headline] {time.perf_counter() - t0:.1f} s', flush=True)

  modules = (viterbi, fused_scan, numerator_scan, trigram_scan)
  # Phase 8: the confidence main path.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  marginals_record, arc_launches = phase_confidence(
      torch, gnat, presets, fused_scan, joint_head, modules)
  print(f'[confidence] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 8b: label_marginals at bench config 8.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  phase_confidence_headline(torch, lattices, contexts, alignments,
                            weight_fns, fused_scan)
  print(f'[confidence-headline] {time.perf_counter() - t0:.1f} s',
        flush=True)

  # Phase 9: the large-vocabulary main path (training, decode).
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  mode, large_launches, large_decodes, large_viterbi_ms = phase_large_vocab(
      torch, gnat, presets, fused_scan, semirings, pytree, viterbi)
  print(f'[large-vocab] {time.perf_counter() - t0:.1f} s', flush=True)
  viterbi_record['launches'] += large_decodes
  viterbi_record['launches_by_path'][
      'gnat_global_bigram(vocab_size=4096) decode'] = large_decodes
  viterbi_record['v4096_ms'] = large_viterbi_ms
  if mode == 'cache':
    for record, count in zip((records['forward'], records['backward']),
                             large_launches):
      record['launches'] += count
      record['launches_by_path'] = {
          'gnat_global_bigram train steps': record['launches'] - count,
          'gnat_global_bigram(vocab_size=4096) train steps': count}

  # Phase 9b: the online kernels at bench config 9.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  online_records = phase_config9(torch, lattices, contexts, alignments,
                                 weight_fns, fused_scan, modules,
                                 (mode, large_launches))
  print(f'[config9] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 10: the trigram main path (training, decode, posteriors).
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  trigram_records, trigram_jh_launches = phase_trigram(
      torch, gnat, presets, fused_scan, trigram_scan, joint_head, semirings,
      pytree, modules)
  print(f'[trigram] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 10b: the trigram kernels at the JAX package's trigram probe shapes.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  phase_trigram_probe(torch, lattices, contexts, alignments, weight_fns,
                      trigram_scan, trigram_records)
  print(f'[trigram-probe] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 11: the NextStateTable main path (training, decode, posteriors).
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  jh_launches = phase_next_state(torch, lattices, contexts, alignments,
                                 weight_fns, gnat, fused_scan, joint_head,
                                 semirings, pytree, modules)
  print(f'[next-state] {time.perf_counter() - t0:.1f} s', flush=True)
  jh_launches['gnat_global_bigram arc_marginals (B=2, T=100)'] = {
      'forward_launches': arc_launches, 'backward_launches': 0}
  for path, count in trigram_jh_launches.items():
    jh_launches[path] = {'forward_launches': count, 'backward_launches': 0}

  # Phase 11b: the joint+head kernels alone.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  jh_records = phase_joint_head_alone(torch, joint_head, jh_launches)
  print(f'[joint-head-alone] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 12: the tensor-parallel training main path.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  tp_launches = phase_tensor_parallel(torch, gnat, presets, fused_scan,
                                      sharded_scan, sharding, pytree)
  print(f'[tensor-parallel] {time.perf_counter() - t0:.1f} s', flush=True)

  # Phase 12b: the frame_reduce kernels alone, and D=4 shards vs D=1.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  fr_records = phase_frame_reduce_alone(torch, sharded_scan, tp_launches)
  print(f'[frame-reduce-alone] {time.perf_counter() - t0:.1f} s',
        flush=True)
  # Phase 13: the expected-risk (MWER) main path.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  mwer_launches, f32_numbers = phase_mwer(
      torch, gnat, presets, risk, lattices, fused_scan, joint_head,
      numerator_scan, viterbi, trigram_scan, sharded_scan, pytree)
  print(f'[mwer] {time.perf_counter() - t0:.1f} s', flush=True)
  mwer_path = f'gnat_global_bigram MWER steps ({TRAIN_STEPS})'
  for record, key in ((jh_records['forward'], 'joint_head.forward_launches'),
                      (jh_records['backward'],
                       'joint_head.backward_launches'),
                      (records['forward'], 'fused_scan.forward_launches'),
                      (records['backward'], 'fused_scan.backward_launches')):
    record['launches'] += mwer_launches.get(key, 0)
    record.setdefault('launches_by_path', {})[mwer_path] = mwer_launches.get(
        key, 0)
  for key in ('forward', 'backward'):
    jh_records[key].update(f32_numbers[key])

  # Phase 13b: forced alignment.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  align_launches = phase_align(torch, gnat, presets, numerator_scan,
                               semirings, modules + (joint_head,
                                                     sharded_scan))
  print(f'[align] {time.perf_counter() - t0:.1f} s', flush=True)
  numerator_forward = numerator_records[0]
  numerator_forward['launches_by_path'] = {
      'hat_bigram train steps': numerator_forward['launches'],
      'hat_bigram align': align_launches}
  numerator_forward['launches'] += align_launches

  # Phase 14: the CTC topology (S = 1) and path entropy.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  entropy_launches = phase_ctc(torch, gnat, presets, lattices, contexts,
                               alignments, weight_fns, semirings, joint_head,
                               pytree, modules + (joint_head, sharded_scan))
  print(f'[ctc] {time.perf_counter() - t0:.1f} s', flush=True)
  entropy_path = (f'hat_bigram(vocab_size=1024) path entropy '
                  f'(B={len(ENTROPY_NUM_FRAMES)}, '
                  f'T={max(ENTROPY_NUM_FRAMES)})')
  jh_records['forward']['launches'] += entropy_launches
  jh_records['forward']['launches_by_path'][entropy_path] = entropy_launches

  # Phase 15: streaming serving and the trainer.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  stream_launches = phase_streaming(
      torch, gnat, presets, encoder_lib, streaming, train_lib, data_lib,
      checkpoint_lib, fused_scan, viterbi, sharded_scan, semirings, pytree)
  print(f'[streaming] {time.perf_counter() - t0:.1f} s', flush=True)
  by_counter = {'forward_launches': records['forward'],
                'backward_launches': records['backward'],
                'online_forward_launches': online_records[0],
                'online_backward_launches': online_records[1],
                'viterbi': viterbi_record}
  for counter, paths in stream_launches.items():
    record = by_counter[counter]
    for path, count in paths.items():
      record['launches'] += count
      record.setdefault('launches_by_path', {})[path] = count

  # Phase 16: time sharding (the relay seeds, the steps, decode and align).
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  seq_launches = phase_time_sharding(
      torch, gnat, presets, fused_scan, trigram_scan, sharded_scan,
      joint_head, sharding, sequence, pytree)
  print(f'[time-sharding] {time.perf_counter() - t0:.1f} s', flush=True)
  by_counter.update({
      'frame_reduce forward_launches': fr_records['forward'],
      'frame_reduce backward_launches': fr_records['backward'],
      'joint_head forward_launches': jh_records['forward'],
      'joint_head backward_launches': jh_records['backward']})

  # Phase 17: pipeline (GPipe) and Megatron-sharded training.
  t0 = time.perf_counter()
  torch.cuda.empty_cache()
  mp_launches = phase_model_parallel(torch, gnat, presets, fused_scan,
                                     joint_head, sharded_scan, sharding,
                                     pipeline, pytree)
  print(f'[model-parallel] {time.perf_counter() - t0:.1f} s', flush=True)
  for launches in (seq_launches, mp_launches):
    for counter, paths in launches.items():
      record = by_counter[counter]
      for path, count in paths.items():
        record['launches'] += count
        record.setdefault('launches_by_path', {})[path] = count
  print(f'[total] {time.perf_counter() - start:.1f} s', flush=True)

  print(json.dumps({'kernels': [viterbi_record, records['forward'],
                                records['backward'], *numerator_records,
                                marginals_record, *online_records,
                                trigram_records['forward'],
                                trigram_records['backward'],
                                jh_records['forward'],
                                jh_records['backward'],
                                fr_records['forward'],
                                fr_records['backward']]}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu',
      'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count(),
  }}))


if __name__ == '__main__':
  try:
    main()
  except SmokeFailure as failure:
    print(f'FAILED: {failure}', flush=True)
    sys.exit(1)
