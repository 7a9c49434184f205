"""A layer's inputs as the timed path stages them, for the readers that time
one layer call alone: the pool's first batch through the program's encoder
and the lattice's projections, with the parameters the window left."""

from __future__ import annotations

import torch


def encoded(session, batch, params) -> torch.Tensor:
  with torch.no_grad():
    return session.model.encoder.apply(params['encoder'], batch.frames,
                                       batch.num_frames)


def lattice_inputs(session, batch, params):
  """(pf [T, B, h], pc [S, h], head, is_pad [T, B]) as the log-partition
  and Viterbi kernels take them (``fused_scan._stage``,
  ``viterbi.viterbi_decode``)."""
  with torch.no_grad():
    enc = encoded(session, batch, params)
    wf = {k: v.detach() for k, v in params['lattice']['weight_fn'].items()}
    cache = session.model.lattice.build_cache(params['lattice']).detach()
    pf = torch.einsum('btf,fh->tbh', enc, wf['frame_proj']).contiguous()
    pc = (cache @ wf['context_proj']).contiguous()
  head = {n: wf[n] for n in ('vocab_w', 'vocab_b', 'blank_w', 'blank_b')}
  max_t = batch.frames.shape[1]
  is_pad = (torch.arange(max_t, device=pf.device)[:, None] >=
            batch.num_frames[None, :])
  return pf, pc, head, is_pad, wf, cache, enc
