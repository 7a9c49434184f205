"""How far the float32 log-partition gradients drift from float64 at T=1600.

A check run by hand; it defines no test for pytest to collect, because it
takes too long for the test suite (about 15 s at T=1600 on a CPU, most of
it JAX's interpret mode):

  PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_blank_drift.py \
      [--max-t 1600]

It draws one bigram FLD(2) input (B=2, V=8, h=16, S=V+1, lengths [T,
3T/4]) with numpy and computes the gradients of sum_b g_b log Z_b three
ways: the JAX package's Pallas kernel pair in interpret mode, float32
(``fused_shortest_distance_fwd`` / ``run_fused_backward``); the port's
plain versions of its CUDA kernels, float32 (``fused_forward_plain`` /
``fused_backward_plain``); and the same plain versions in float64, the
reference. It prints, for each head gradient and for d(pf) and d(pc), the
largest error of each float32 route against float64 as a fraction of the
largest float64 gradient of any parameter, as the port's phase 12 judges
the blank head.
"""

import argparse
import time

import jax.numpy as jnp
import numpy as np
import torch

from last_torch_tpu.ops import fused_scan as jax_fused_scan
from last_torch_tpu_torch.ops import fused_scan

VOCAB, HIDDEN = 8, 16
STATES = VOCAB + 1
MAX_EXPANSIONS = 2


def make_inputs(max_t, seed=0):
  rng = np.random.default_rng(seed)
  normal = lambda *shape: rng.standard_normal(shape).astype(np.float32)
  wf_params = {
      'frame_proj': np.eye(HIDDEN, dtype=np.float32),
      'context_proj': normal(STATES, HIDDEN) * 0.7,
      'vocab_w': normal(HIDDEN, VOCAB) * 0.5,
      'vocab_b': normal(VOCAB) * 0.1,
      'blank_w': normal(HIDDEN) * 0.5,
      'blank_b': np.float32(0.2),
  }
  num_frames = np.array([max_t, max_t * 3 // 4], np.int32)
  frames = normal(len(num_frames), max_t, HIDDEN)
  g = np.array([1.0, 0.7], np.float32)
  return wf_params, frames, num_frames, g


def jax_gradients(wf_params, frames, num_frames, g):
  """(d_wf, d_frames) of the JAX kernel pair in interpret mode, float32."""
  kw = dict(max_expansions=MAX_EXPANSIONS, frame_dependent=False,
            num_context_states=STATES, compute_dtype=jnp.float32,
            interpret=True)
  jax_wf = {n: jnp.asarray(x) for n, x in wf_params.items()}
  cache = jnp.eye(STATES, dtype=jnp.float32)
  outs = jax_fused_scan.fused_shortest_distance_fwd(
      jax_wf, cache, jnp.asarray(frames), num_frames,
      return_final_alpha=True, with_expansions=True, **kw)
  d_wf, _, d_frames, _ = jax_fused_scan.run_fused_backward(
      jax_wf, cache, jnp.asarray(frames), num_frames, outs[0],
      jnp.asarray(g), outs[1], expansion_history=outs[3], **kw)
  grads = {n: np.asarray(d_wf[n], np.float64) for n in
           ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  grads['pc'] = np.asarray(d_wf['context_proj'], np.float64)
  grads['pf'] = np.asarray(d_frames, np.float64).transpose(1, 0, 2)
  return grads


def port_gradients(wf_params, frames, num_frames, g, dtype):
  """The port's plain kernel pair in ``dtype`` (float32 or float64)."""
  max_t = frames.shape[1]
  pf = torch.from_numpy(frames).transpose(0, 1).contiguous().to(dtype)
  pc = torch.from_numpy(wf_params['context_proj']).to(dtype)
  head = {k: torch.tensor(wf_params[k]).to(dtype)
          for k in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  is_pad = (torch.arange(max_t)[:, None] >=
            torch.from_numpy(num_frames)[None])
  kw = dict(max_expansions=MAX_EXPANSIONS, frame_dependent=False,
            compute_dtype=torch.float32)
  log_z, _, hist, slabs = fused_scan.fused_forward_plain(
      pf, pc, head, is_pad, with_residuals=True, **kw)
  dpf, dpc, dvw, dvb, dbw, dbb, _ = fused_scan.fused_backward_plain(
      pf, pc, head, is_pad, log_z, torch.from_numpy(g).to(dtype), hist,
      slabs, **kw)
  return {'vocab_w': dvw, 'vocab_b': dvb, 'blank_w': dbw, 'blank_b': dbb,
          'pc': dpc, 'pf': dpf}


def main():
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--max-t', type=int, default=1600)
  args = parser.parse_args()
  torch.set_float32_matmul_precision('highest')
  inputs = make_inputs(args.max_t)
  t0 = time.perf_counter()
  reference = {n: x.double().numpy() for n, x in
               port_gradients(*inputs, torch.float64).items()}
  port = {n: x.double().numpy() for n, x in
          port_gradients(*inputs, torch.float32).items()}
  t1 = time.perf_counter()
  jax_grads = jax_gradients(*inputs)
  t2 = time.perf_counter()
  largest = max(np.abs(reference[n]).max() for n in
                ('vocab_w', 'vocab_b', 'blank_w', 'blank_b', 'pc'))
  print(f'T={args.max_t} B=2 V={VOCAB} h={HIDDEN} FLD({MAX_EXPANSIONS}) '
        f'float32; port plain {t1 - t0:.1f} s (with float64), JAX '
        f'interpret {t2 - t1:.1f} s; largest float64 parameter gradient '
        f'{largest:.6g}')
  for name in ('blank_b', 'blank_w', 'vocab_b', 'vocab_w', 'pc', 'pf'):
    err = lambda got: np.abs(got - reference[name]).max() / largest
    print(f'{name}: float64 {np.abs(reference[name]).max():.6g} (max |.|); '
          f'JAX float32 drift {err(jax_grads[name]):.3e}, port float32 '
          f'drift {err(port[name]):.3e} of the largest gradient')


if __name__ == '__main__':
  main()
