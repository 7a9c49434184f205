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

"""Smoke run of the PyTorch port's serving path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases:

1. Device: requires CUDA, prints the card's name and power limit, turns
   TF32 off for float32 matmuls and convolutions.
2. Build: compiles ``last_torch_tpu_torch/csrc/viterbi.cu`` for sm_90a.
3. Kernel against its plain PyTorch version on the card, T=64, B=4,
   V in {1024, 1000}, FD / FLD(1) / FLD(2), float32 and bfloat16.
4. Main path: ``GNATModel(presets.gnat_global_bigram(), device='cuda')``
   with random weights from a seed decodes 8 requests at T_max=1600 through
   the kernel, is checked, and is compared with the same decode through the
   plain version; both are timed with CUDA events.

Each phase prints one line; any failure exits non-zero before the last
line, which is ``{"ok": true, "device": {...}}``. The line before it is the
kernels' JSON record. Imports nothing of JAX.
"""

import json
import subprocess
import sys
import time

import numpy as np

# Phase-4 request lengths (frames at 100 frames/s; 16 s at most).
NUM_FRAMES = [1600, 1523, 1400, 1211, 1000, 804, 517, 230]
# Tolerances, relative. float32: kernel and plain differ in summation order
# only. bfloat16: both round the same inputs; the f32 sums still differ in
# order, which can flip near-tied argmaxes (ROADMAP: bf16 decode near-ties).
F32_RTOL = 1e-5
BF16_RTOL = 1e-4
BF16_MIN_SLOT_AGREEMENT = 0.999


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


def rescore(torch, labels, num_frames, pf, pc, params, *, max_expansions,
            frame_dependent, compute_dtype):
  """Scores of the given alignments under the plain arc weights (float64).

  Walks each alignment through the bigram context: a lexical slot y from
  state q scores lex[q, y] and moves to state y; the frame's blank slot
  scores blank[q].
  """
  rnd = lambda x: x.to(compute_dtype).float()
  vw_t = rnd(params['vocab_w']).t()
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
      is_blank_slot = frame_dependent or i == num_align - 1
      if is_blank_slot:
        weight = torch.where(y > 0, lexical, blank)
      else:
        weight = torch.where(y > 0, lexical, torch.zeros_like(lexical))
      score += torch.where(real, weight, 0.0).double()
      q = torch.where(real & (y > 0), y, q)
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
    vecs = [alpha_t]  # each pass's input: alpha, then expand(red)
    for _ in range(arg_k.shape[2]):
      red = (vecs[-1][:, None] + lex).max(dim=0).values
      vecs.append(torch.cat([red.new_full((1,), float('-inf')), red]))
    if kind == 'arg':
      j, y = where
      score = lambda s: vecs[j][s] + lex[s, y]
      mine, theirs = int(arg_k[t, b, j, y]), int(arg_p[t, b, j, y])
    else:
      (s,) = where
      blank = joint[s] @ bw + bb
      score = lambda jj: vecs[jj][s] + blank
      mine, theirs = int(jstar_k[t, b, s]), int(jstar_p[t, b, s])
    a, c = score(mine).item(), score(theirs).item()
    gaps.append(abs(a - c) / max(abs(c), 1.0))
  return len(diffs), max(gaps, default=0.0)


def phase_kernel_vs_plain(torch, viterbi):
  """Phase 3: the kernel against its plain version on the card."""
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
    for name, k, fd in (('FD', 0, True), ('FLD(1)', 1, False),
                        ('FLD(2)', 2, False)):
      for dtype in (torch.float32, torch.bfloat16):
        kw = dict(max_expansions=k, frame_dependent=fd, compute_dtype=dtype)
        fwd_k = viterbi.viterbi_forward(pf, pc, params, is_pad, **kw)
        fwd_p = viterbi.viterbi_forward_plain(pf, pc, params, is_pad, **kw)
        torch.cuda.synchronize()
        bt = dict(max_expansions=k, frame_dependent=fd)
        labels_k, weights_k = viterbi.backtrace(*fwd_k, is_pad, **bt)
        labels_p, weights_p = viterbi.backtrace(*fwd_p, is_pad, **bt)
        num = (1 if fd else k + 1) * num_frames
        tag = f'V={vocab} {name} {str(dtype)[6:]}'
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


def main():
  import torch
  if not torch.cuda.is_available():
    raise SmokeFailure('no CUDA device: torch.cuda.is_available() is False')
  try:
    from last_torch_tpu_torch.models import gnat, presets
    from last_torch_tpu_torch.ops import build, viterbi
  except ImportError as e:
    raise SmokeFailure(f'run from the root of a checkout ({e})') from None

  # Phase 1: device.
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  print(card_line(), flush=True)  # name, power.limit as nvidia-smi gives
  print(f'[device] torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}, '
        'TF32 off', flush=True)

  # Phase 2: build from the checkout's sources (a stale build is removed).
  library = build.library_path('viterbi.cu')
  library.unlink(missing_ok=True)
  t0 = time.perf_counter()
  viterbi.library()
  build_s = time.perf_counter() - t0
  ptxas = [line.strip() for line in
           library.with_suffix('.log').read_text().splitlines()
           if 'registers' in line or 'spill' in line]
  print(f'[build] viterbi.cu for sm_90a in {build_s:.1f} s; ptxas: '
        + ' | '.join(ptxas), flush=True)

  # Phase 3: kernel against plain.
  for line in phase_kernel_vs_plain(torch, viterbi):
    print(f'[kernel-vs-plain] {line}', flush=True)

  # Phase 4: the main path, gnat_global_bigram at full width.
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

  print(json.dumps({'kernels': [{
      'name': 'viterbi_forward',
      'route': 'cuda',
      'source': 'last_torch_tpu_torch/csrc/viterbi.cu',
      'replaces': 'last_torch_tpu/ops/viterbi.py:46',
      'launches': launches,
      'max_abs_err': max_abs_err,
      'ms': kernel_ms,
      'plain_ms': plain_ms,
  }]}))
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
